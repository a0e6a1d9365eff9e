"""Run one cluster node of the port with the interactive shell.

    python -m idunno_tpu_torch --host node0 [--config cluster.json] \
        [--data-dir ./node0-data] [--dataset ./images] [--no-shell] [--cpu]

A port of ``idunno_tpu/__main__.py``. The config JSON mirrors
``ClusterConfig`` (hosts, coordinator, standby_coordinator, introducer,
ports, timeouts); an ``addresses`` map {host: ip} may be included for
multi-machine deployments — otherwise all hosts resolve to 127.0.0.1 with
per-host port offsets (single-machine clusters), replacing the reference's
hardcoded IP tables (`utils.py:70-92`). Its ``engine`` block builds the
port's ``EngineConfig``, whose ``preprocess`` values are the port's
(``auto|fold|kernel|plain``).

The node runs on the CUDA card (its engine over every visible card, one
data group each). ``--cpu`` puts the engine and every LM pool on the CPU
instead (tests); without it, a machine with no card exits non-zero.

``--dist-coordinator host:port --dist-num-processes N --dist-process-id I``
(the JAX package's ``--jax-*`` flags) join this process to a
``torch.distributed`` group of N before the node is built
(``parallel/mesh.py:initialize_distributed``; NCCL when every process has
a card of its own, gloo otherwise); every process passes the same
coordinator, where process 0 listens.
"""
from __future__ import annotations

import argparse
import json
import sys


def build_addr_of(config, addresses: dict[str, str]):
    def addr_of(host: str):
        ip = addresses.get(host, "127.0.0.1")
        # distinct ports per host when everything is local
        offset = (0 if addresses.get(host) else
                  100 * config.hosts.index(host))
        return (ip, config.ports.store + offset,
                config.ports.membership + offset)
    return addr_of


def load_config(path: str | None):
    """(ClusterConfig, addresses, EngineConfig | None) from a config JSON,
    or the environment's ClusterConfig when ``path`` is None."""
    from idunno_tpu_torch.config import (ClusterConfig, EngineConfig,
                                         PortConfig)

    if path is None:
        return ClusterConfig.from_env(), {}, None
    with open(path) as f:
        raw = json.load(f)
    addresses = raw.pop("addresses", {})
    engine_raw = raw.pop("engine", None)
    engine_config = (EngineConfig(**engine_raw) if engine_raw is not None
                     else None)
    if "ports" in raw:
        raw["ports"] = PortConfig(**raw["ports"])
    if "hosts" in raw:
        raw["hosts"] = tuple(raw["hosts"])
    return ClusterConfig(**raw), addresses, engine_config


def build_node(host: str, config, addresses: dict[str, str], data_dir: str,
               engine_config=None, dataset_root: str | None = None,
               device=None):
    """One node as ``main`` assembles it: a ``NetTransport`` on the
    config's ports and a ``Node`` whose engine runs on ``device`` (the
    card unless ``"cpu"``; no card raises). Not started."""
    from idunno_tpu_torch.comm.net import NetTransport
    from idunno_tpu_torch.engine.inference import resolve_device
    from idunno_tpu_torch.serve.node import Node

    device = resolve_device(device)     # before any socket is bound
    transport = NetTransport(host, build_addr_of(config, addresses))
    return Node(host, config, transport, data_dir=data_dir,
                engine_config=engine_config, dataset_root=dataset_root,
                device=device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="idunno_tpu_torch")
    ap.add_argument("--host", required=True, help="this node's name")
    ap.add_argument("--config", help="cluster config JSON")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--dataset", default=None,
                    help="local dataset root (test_<N>.JPEG files)")
    ap.add_argument("--no-shell", action="store_true",
                    help="run headless (no interactive shell)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine and every LM pool on the CPU "
                         "(tests; by default the node runs on the card)")
    ap.add_argument("--dist-coordinator", default=None,
                    help="host:port for torch.distributed bring-up (process "
                         "0 listens there); all processes pass the same "
                         "value")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)
    args = ap.parse_args(argv)

    from idunno_tpu_torch.cli.shell import Shell
    from idunno_tpu_torch.engine.inference import resolve_device

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:        # no card and no --cpu
        print(f"idunno_tpu_torch: {e}", file=sys.stderr)
        return 1
    config, addresses, engine_config = load_config(args.config)
    if args.host not in config.hosts:
        ap.error(f"--host {args.host!r} not in configured hosts")
    if args.dist_coordinator:
        from idunno_tpu_torch.parallel.mesh import initialize_distributed
        initialize_distributed(args.dist_coordinator,
                               num_processes=args.dist_num_processes,
                               process_id=args.dist_process_id)
    node = build_node(args.host, config, addresses,
                      data_dir=args.data_dir or f"./{args.host}-data",
                      engine_config=engine_config,
                      dataset_root=args.dataset, device=device)
    node.start()
    try:
        if args.no_shell:
            import signal
            import threading
            # a terminated headless node stops its services (and its LM
            # pools' loops) on the way out
            signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
            threading.Event().wait()
        else:
            Shell(node).run()
    except KeyboardInterrupt:
        pass
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
