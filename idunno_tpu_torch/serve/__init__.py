from idunno_tpu_torch.serve.metrics import MetricsTracker  # noqa: F401
from idunno_tpu_torch.serve.inference_service import InferenceService  # noqa: F401
