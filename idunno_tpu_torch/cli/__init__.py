from idunno_tpu_torch.cli.shell import Shell  # noqa: F401
