"""idunno_tpu_torch — the CNN inference framework of ``idunno_tpu``, ported
to PyTorch and CUDA for an NVIDIA H100.

The JAX package ``idunno_tpu`` beside it is the reference; this package
imports nothing of it and nothing of JAX. What is here so far is the CNN
serving path: the control plane (membership, fair scheduler, inference
service, metrics) copied as it is, the ResNet and AlexNet models as
``nn.Module``s with torchvision parameter names, the inference engine, and
the one TPU kernel on that path, the fused crop + normalize, rewritten as a
hand-written CUDA kernel for Hopper (``csrc/preprocess.cu``). ROADMAP.md
lists what is still to port.

Package layout:
    config      — cluster/runtime configuration
    utils       — enums, hash ring, trace spans
    comm        — transports + typed control-plane messages
    membership  — join/heartbeat/failure detector
    models      — ResNet / AlexNet, the folded stem, the weight carry
    ops         — preprocessing (plain and CUDA kernel), classification
    engine      — batched inference on one device
    scheduler   — fair-time multi-job scheduling, task bookkeeping
    serve       — coordinator/worker inference service, metrics
    csrc        — CUDA sources, built with nvcc at first use
"""

__version__ = "0.1.0"

# Lazy top-level API (PEP 562): importing the package stays light.
_LAZY_API = {
    "InferenceEngine": ("idunno_tpu_torch.engine.inference", "InferenceEngine"),
    "QueryResult": ("idunno_tpu_torch.engine.inference", "QueryResult"),
    "ClusterConfig": ("idunno_tpu_torch.config", "ClusterConfig"),
    "EngineConfig": ("idunno_tpu_torch.config", "EngineConfig"),
}


def __getattr__(name):
    if name in _LAZY_API:
        import importlib
        mod, attr = _LAZY_API[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'idunno_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_API))
