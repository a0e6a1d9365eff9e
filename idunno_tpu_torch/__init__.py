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
  (``csrc/paged_attention.cu``) through the block table;
- slice 3, training: the LM train step (next-token cross-entropy, fused
  AdamW over f32 master parameters, bf16 compute) with the flash
  backward kernels (``csrc/flash_attention_bwd.cu``: dQ, and dK/dV)
  joined to the forward in one ``torch.autograd.Function``, the
  ResNet-18 train step, ``TokenDataset`` and the train bench;
- later slices: int8 weights, the space-to-depth stem, native staging,
  ViT; speculative decoding and beam search, and each all-greedy decode
  dispatch replayed as one CUDA graph;
- slice 8, the cluster node: ``python -m idunno_tpu_torch --host n0``
  starts a ``Node`` (``serve/node.py``) whose engine and LM pools run on
  the card: the replicated store, checkpoints and LM blobs in the port's
  own format, ``store://`` datasets, the control RPC (``serve/control.py``:
  ``inference``, ``generate``, ``lm_serve``/``lm_submit``/``lm_poll``, ...),
  failover, the LM pool manager and autoscaler, the log grep and the
  shell;
- slice 11, the routed FFN: ``models/moe.py`` (``SwitchFFN``,
  ``MoETransformerLM``, the balance loss) over the single-device
  ``parallel/expert.py:switch_dispatch``, trained (``remat`` per block)
  and served from the contiguous cache or a gathered block pool; the
  CNNs' compute dtype beside their parameters' dtype;
- slice 12, tensor-parallel decode over a ``(data, model)`` mesh;
- slice 13, data parallelism: the engine over a mesh (K1 per data
  group), the data-parallel and FSDP train steps, global BatchNorm,
  processes joined by ``torch.distributed`` (``initialize_distributed``,
  ``global_mesh``), and ``python -m idunno_tpu_torch.dryrun``.

Every kernel runs on a CUDA tensor and falls to its plain PyTorch version
only for a CPU tensor. ROADMAP.md lists what is still to port.

Package layout:
    config      — cluster/runtime configuration
    utils       — enums, hash ring, trace spans, the LM and train bench
    comm        — transports (in-process, real sockets) + typed
                  control-plane messages
    membership  — join/heartbeat/failure detector
    models      — ResNet / AlexNet, the folded stem, TransformerLM and
                  its switch-MoE family, the weight carry from flax
    parallel    — meshes (virtual ones over one device; across
                  processes), the data-axis collectives, the sharding
                  policies, the single-device switch dispatch
    ops         — preprocessing, classification, attention (plain, flash,
                  paged), sampling
    engine      — batched CNN inference, LM generation, the KV block
                  pool, the continuous-batching decode server, the CNN
                  and LM train steps and the LM token dataset,
                  checkpoints and datasets in the store
    store       — the replicated versioned file store (SDFS)
    scheduler   — fair-time multi-job scheduling, task bookkeeping
    serve       — the node, the control RPC, failover, the LM pool
                  manager and autoscaler, inference service, metrics, LM
                  serving loop, admission gateway, radix prefix cache
    grep        — distributed log grep
    cli         — the interactive shell
    csrc        — CUDA sources, built with nvcc at first use
"""

__version__ = "0.3.0"

# Lazy top-level API (PEP 562): importing the package stays light.
_LAZY_API = {
    "InferenceEngine": ("idunno_tpu_torch.engine.inference", "InferenceEngine"),
    "QueryResult": ("idunno_tpu_torch.engine.inference", "QueryResult"),
    "ClusterConfig": ("idunno_tpu_torch.config", "ClusterConfig"),
    "EngineConfig": ("idunno_tpu_torch.config", "EngineConfig"),
    "TransformerLM": ("idunno_tpu_torch.models.transformer", "TransformerLM"),
    "MoETransformerLM": ("idunno_tpu_torch.models.moe", "MoETransformerLM"),
    "DecodeServer": ("idunno_tpu_torch.engine.serve_lm", "DecodeServer"),
    "LMServingLoop": ("idunno_tpu_torch.serve.lm_pool", "LMServingLoop"),
    "generate": ("idunno_tpu_torch.engine.generate", "generate"),
    "TrainState": ("idunno_tpu_torch.engine.train", "TrainState"),
    "create_train_state": ("idunno_tpu_torch.engine.train",
                           "create_train_state"),
    "make_train_step": ("idunno_tpu_torch.engine.train", "make_train_step"),
    "create_lm_train_state": ("idunno_tpu_torch.engine.train_lm",
                              "create_lm_train_state"),
    "make_lm_train_step": ("idunno_tpu_torch.engine.train_lm",
                           "make_lm_train_step"),
    "TokenDataset": ("idunno_tpu_torch.engine.data_lm", "TokenDataset"),
    "run_train_bench": ("idunno_tpu_torch.utils.train_bench",
                        "run_train_bench"),
    "make_mesh": ("idunno_tpu_torch.parallel.mesh", "make_mesh"),
    "local_mesh": ("idunno_tpu_torch.parallel.mesh", "local_mesh"),
    "global_mesh": ("idunno_tpu_torch.parallel.mesh", "global_mesh"),
    "initialize_distributed": ("idunno_tpu_torch.parallel.mesh",
                               "initialize_distributed"),
}


def __getattr__(name):
    if name in _LAZY_API:
        import importlib
        mod, attr = _LAZY_API[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'idunno_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_API))
