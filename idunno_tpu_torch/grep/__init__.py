from idunno_tpu_torch.grep.loggrep import LogGrepService  # noqa: F401
