from idunno_tpu_torch.engine.inference import InferenceEngine, QueryResult  # noqa: F401
