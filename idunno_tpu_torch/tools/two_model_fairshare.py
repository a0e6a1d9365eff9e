"""The reference's signature experiment on the port: two models served at
once under fair-time arbitration, on the card.

The port's counterpart of ``tools/two_model_fairshare.py`` (its header
tells the experiment's history; reference: ``mp4_report_group1.pdf`` p.1-2,
the ratio formula ``mp4_machinelearning.py:504-514``, worked example 7/3).
A three-node in-process cluster of the port's ``Node``s (``comm/inproc.py``
transport) shares the card, each node with its own engine, every batch
through the preprocess kernel K1 (``preprocess="kernel"``). It streams
heavy ``resnet50`` queries (768 images each), starts a light ``alexnet``
stream (192-image queries) while they are in flight, and records:

- the measured seconds a query of each model (the formula's inputs);
- the coordinator's allocation view, polled while both jobs are live,
  every both-live snapshot's shares held against ``scheduler/fair.py:
  fair_shares`` on that snapshot's inputs (``shares_match_fair_shares``);
- the time from the second job's submission to its first result;
- each model's images/s while both streams are live, and the images/s
  of the whole concurrent stretch;
- on the card, K1's launches over the concurrent stretch.

    python -m idunno_tpu_torch.tools.two_model_fairshare          # the card
    python -m idunno_tpu_torch.tools.two_model_fairshare --cpu \\
        --heavy-images 16 --light-images 8 --queries 2 --batch 8 \\
        --image-size 64                                        # machinery

The record goes to ``chiprun_out/two_model_fairshare_torch.json`` unless
``--out`` says otherwise. On the CPU the engines compute in f32 and the
record holds no launches.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

HEAVY, LIGHT = "resnet50", "alexnet"


def run(dev, *, heavy_images: int = 768, light_images: int = 192,
        queries: int = 6, batch: int = 64, image_size: int = 224,
        timeout_s: float = 900.0) -> dict:
    """The experiment on ``dev`` (module docstring); returns its record
    without provenance. Raises ``TimeoutError`` when the queries are not
    done within ``timeout_s``."""
    import shutil

    from idunno_tpu_torch.comm.inproc import InProcNetwork
    from idunno_tpu_torch.config import ClusterConfig, EngineConfig
    from idunno_tpu_torch.ops.launches import read_launches, zero_launches
    from idunno_tpu_torch.scheduler.fair import fair_shares
    from idunno_tpu_torch.serve.node import Node

    card = dev.type == "cuda"
    # the allocation view's polling period: the CPU's tiny queries finish
    # within a few of the card's periods
    poll_s = 0.2 if card else 0.02
    cfg = ClusterConfig(hosts=("n0", "n1", "n2"), coordinator="n0",
                        standby_coordinator="n1", introducer="n0",
                        replication_factor=2, ping_interval_s=0.2,
                        failure_timeout_s=2.0, metadata_interval_s=0.3,
                        query_batch_size=max(heavy_images, light_images))
    resize = image_size * 256 // 224
    ecfg = EngineConfig(batch_size=batch, image_size=image_size,
                        resize_size=resize, preprocess="kernel",
                        param_dtype="bfloat16" if card else "float32",
                        compute_dtype="bfloat16" if card else "float32")
    net = InProcNetwork()
    tmp = tempfile.mkdtemp(prefix="fairshare2m-")
    nodes = {h: Node(h, cfg, net.transport(h), os.path.join(tmp, h),
                     engine_config=ecfg, device=dev) for h in cfg.hosts}
    n_img = {HEAVY: heavy_images, LIGHT: light_images}
    out: dict = {"images_per_query": n_img, "batch": batch,
                 "image_size": image_size, "queries": queries,
                 "engine_param_dtype": ecfg.param_dtype,
                 "engine_compute_dtype": ecfg.compute_dtype}
    try:
        for n in nodes.values():
            n.start()
        deadline = time.time() + 10.0
        while time.time() < deadline and not all(
                len(n.membership.members.alive_hosts()) == 3
                for n in nodes.values()):
            time.sleep(0.05)
        master = nodes["n0"]
        svc = master.inference

        def submit(model):
            return svc.inference(model, 0, n_img[model] - 1)[0]

        give_up = time.time() + timeout_s

        def waiting() -> None:
            if time.time() > give_up:
                raise TimeoutError(f"queries still open after {timeout_s} "
                                   "s (a failed task never completes)")

        def run_query(model):
            q = submit(model)
            while not svc.query_done(model, q):
                waiting()
                time.sleep(0.02)
            return q

        # warm both models: the first query of each builds its weights and
        # kernels; its time must not feed the fair-share signal
        for model in (HEAVY, LIGHT):
            t0 = time.time()
            run_query(model)
            out[f"warm_{model}_s"] = time.time() - t0
        for n in nodes.values():
            n.inference.metrics.reset_processing()
            n.inference.scheduler.avg_query_time = {}

        t0 = time.time()
        for _ in range(2):
            run_query(HEAVY)
        out[f"{HEAVY}_alone_s_per_query"] = (time.time() - t0) / 2

        if card:
            zero_launches()
        r_qs = [submit(HEAVY) for _ in range(queries)]
        t_submit2 = time.time()
        a_first = submit(LIGHT)
        out["second_job_first_task_dispatch_s"] = time.time() - t_submit2
        a_qs = [submit(LIGHT) for _ in range(queries - 1)]

        first_result_s = None
        both_live: list[dict] = []
        checks: list[dict] = []
        share_pairs: set[tuple[int, int]] = set()
        pending = {HEAVY: list(r_qs), LIGHT: [a_first, *a_qs]}
        finished: dict = {HEAVY: [], LIGHT: []}   # when each query finished
        t0 = time.time()
        while any(pending.values()):
            for m in (HEAVY, LIGHT):
                left = [q for q in pending[m] if not svc.query_done(m, q)]
                now = time.time()
                finished[m] += [now] * (len(pending[m]) - len(left))
                pending[m] = left
            if first_result_s is None and svc.query_done(LIGHT, a_first):
                first_result_s = time.time() - t_submit2
            view = master.lm_manager.allocation_view()
            jobs = view.get("jobs", {})
            if f"cnn:{HEAVY}" in jobs and f"cnn:{LIGHT}" in jobs:
                both_live.append(view)
                avg = {m: jobs[f"cnn:{m}"]["avg_query_s"]
                       for m in (HEAVY, LIGHT)}
                want = fair_shares(avg, view["rate_factor"],
                                   view["n_workers"])
                got = {m: jobs[f"cnn:{m}"]["share"] for m in (HEAVY, LIGHT)}
                checks.append({"avg_query_s": avg, "shares": got,
                               "fair_shares": want})
                share_pairs.add((got[HEAVY], got[LIGHT]))
            waiting()
            time.sleep(poll_s)
        t_end = time.time()
        if card:
            import torch
            torch.cuda.synchronize()
            out["launches"] = read_launches()
        out["second_job_first_result_s"] = first_result_s
        out["reference_second_job_first_result_s"] = "40-49 (p.2 Fig 3)"
        total = len(r_qs) * n_img[HEAVY] + (len(a_qs) + 1) * n_img[LIGHT]
        out["concurrent_s"] = t_end - t0
        out["concurrent_images_per_s"] = total / (t_end - t0)
        # both streams live: from the light job's submission until the
        # first stream has drained
        live_end = min(max(finished[HEAVY]), max(finished[LIGHT]))
        live_s = live_end - t_submit2
        out["both_live_s"] = live_s
        out["both_live_images_per_s"] = {
            m: (sum(1 for t in finished[m] if t <= live_end) * n_img[m]
                / live_s) if live_s > 0 else None
            for m in (HEAVY, LIGHT)}
        out["allocation_live"] = (both_live[-1] if both_live
                                  else {"error": "no both-live snapshot"})
        out["both_live_snapshots"] = len(both_live)
        out["share_pairs_seen"] = sorted(share_pairs)
        out["share_checks"] = checks[-3:]
        out["shares_match_fair_shares"] = bool(checks) and all(
            c["shares"] == c["fair_shares"] for c in checks)
        ja = out["allocation_live"].get("jobs", {})
        out["asymmetric_split"] = bool(
            ja.get(f"cnn:{HEAVY}", {}).get("share", 0)
            != ja.get(f"cnn:{LIGHT}", {}).get("share", 0))
        out["share_ordering_matches_cost"] = bool(
            ja.get(f"cnn:{HEAVY}", {}).get("share", 0)
            >= ja.get(f"cnn:{LIGHT}", {}).get("share", 0))
        out["avg_query_s"] = dict(svc.scheduler.avg_query_time)
        out["fair_shares"] = fair_shares(svc.scheduler.avg_query_time,
                                         cfg.rate_factor, 3)
        out["workers_last_query"] = {
            m: sorted({t.worker for t in svc.scheduler.book.tasks_for_query(
                m, qs[-1])})
            for m, qs in ((HEAVY, r_qs), (LIGHT, a_qs or [a_first]))}
        return out
    finally:
        for n in nodes.values():
            n.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    import json

    from idunno_tpu_torch.tools import device, parser, stamp, write

    ap = parser(__doc__.splitlines()[0],
                out="two_model_fairshare_torch.json")
    ap.add_argument("--heavy-images", type=int, default=768,
                    help=f"images a {HEAVY} query (a multiple of the batch)")
    ap.add_argument("--light-images", type=int, default=192,
                    help=f"images a {LIGHT} query")
    ap.add_argument("--queries", type=int, default=6,
                    help="queries a model stream")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=224)
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    if dev is None:
        return 2
    rec = stamp(run(dev, heavy_images=args.heavy_images,
                    light_images=args.light_images, queries=args.queries,
                    batch=args.batch, image_size=args.image_size), dev)
    write(rec, args.out)
    print(json.dumps(rec))
    return 0 if rec["shares_match_fair_shares"] else 1


if __name__ == "__main__":
    sys.exit(main())
