from idunno_tpu_torch.store.sdfs import FileStoreService  # noqa: F401
