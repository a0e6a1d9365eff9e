"""idunno_tpu_torch — the inference framework of ``idunno_tpu``, ported to
PyTorch and CUDA for an NVIDIA H100.

The JAX package ``idunno_tpu`` beside it is the reference; this package
imports nothing of it and nothing of JAX. What is here so far:

- slice 1, CNN serving: the control plane (membership, fair scheduler,
  inference service, metrics) copied as it is, ResNet and AlexNet as
  ``nn.Module``s with torchvision parameter names, the inference engine,
  and the fused crop + normalize as a hand-written CUDA kernel
  (``csrc/preprocess.cu``);
- slice 2, LM serving: ``TransformerLM`` (GQA, int8 KV cache, the cached
  decode step), ``generate``, the paged KV block pool and the radix
  prefix cache, the continuous-batching ``DecodeServer`` and its serving
  loop and admission gateway, with flash attention (``csrc/
  flash_attention.cu``) on the full forward and paged decode attention
  (``csrc/paged_attention.cu``) through the block table.

Every kernel runs on a CUDA tensor and falls to its plain PyTorch version
only for a CPU tensor. ROADMAP.md lists what is still to port.

Package layout:
    config      — cluster/runtime configuration
    utils       — enums, hash ring, trace spans, the LM bench config
    comm        — transports + typed control-plane messages
    membership  — join/heartbeat/failure detector
    models      — ResNet / AlexNet, the folded stem, TransformerLM, the
                  weight carry from flax
    ops         — preprocessing, classification, attention (plain, flash,
                  paged), sampling
    engine      — batched CNN inference, LM generation, the KV block
                  pool, the continuous-batching decode server
    scheduler   — fair-time multi-job scheduling, task bookkeeping
    serve       — inference service, metrics, LM serving loop, admission
                  gateway, radix prefix cache
    csrc        — CUDA sources, built with nvcc at first use
"""

__version__ = "0.2.0"

# Lazy top-level API (PEP 562): importing the package stays light.
_LAZY_API = {
    "InferenceEngine": ("idunno_tpu_torch.engine.inference", "InferenceEngine"),
    "QueryResult": ("idunno_tpu_torch.engine.inference", "QueryResult"),
    "ClusterConfig": ("idunno_tpu_torch.config", "ClusterConfig"),
    "EngineConfig": ("idunno_tpu_torch.config", "EngineConfig"),
    "TransformerLM": ("idunno_tpu_torch.models.transformer", "TransformerLM"),
    "DecodeServer": ("idunno_tpu_torch.engine.serve_lm", "DecodeServer"),
    "LMServingLoop": ("idunno_tpu_torch.serve.lm_pool", "LMServingLoop"),
    "generate": ("idunno_tpu_torch.engine.generate", "generate"),
}


def __getattr__(name):
    if name in _LAZY_API:
        import importlib
        mod, attr = _LAZY_API[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'idunno_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_API))
