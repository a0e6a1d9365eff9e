"""Interactive operations shell (SURVEY.md C12).

The full reference command surface (`README.md:31-50`,
`shell` `mp4_machinelearning.py:1111-1229`):

  1  list_mem                      membership list
  2  list_self                     this node's id
  3  join                          join the cluster
  4  leave                         voluntary leave
  5  list_master                   acting master + standby
  6  grep <pattern>                distributed log grep (C14)
  7  put <local> <sdfs>            upload to the file store
  8  get <sdfs> <local>            fetch latest version
  9  delete <sdfs>                 delete from the store
  10 ls <sdfs>                     hosts storing a file
  11 store                         files stored on this host
  12 get-versions <sdfs> <k> <local>  last k versions, delimited
  13 inference <start> <end> <model> [dataset]  submit a query range
       (dataset: local dir or store://<name> published via the file layer)
  c1 query rates + finished counts per model
  c2 processing-time stats of a query per model
  c4 dump all results to result.txt
  cvm  per-host running tasks
  cq   per-query task assignment map

c1/c2 report *measured* numbers — the reference fabricates AlexNet stats as
0.95 × ResNet's and invents quartiles (`preprocess_c1`/`c2`, `:1232-1267`).
"""
from __future__ import annotations

import json
import shlex
import threading
from collections.abc import Callable, Iterable

from idunno_tpu_torch.serve.node import Node

HELP = """\
  1  list_mem                      membership list
  2  list_self                     this node's id
  3  join                          join the cluster
  4  leave                         voluntary leave
  5  list_master                   acting master + standby
  6  grep <pattern>                distributed log grep
  7  put <local> <sdfs>            upload to the file store
  8  get <sdfs> <local>            fetch latest version
  9  delete <sdfs>                 delete from the store
  10 ls <sdfs>                     hosts storing a file
  11 store                         files stored on this host
  12 get-versions <sdfs> <k> <local>  last k versions, delimited
  13 inference <start> <end> <model> [dataset]  submit a query range
       (dataset: local dir or store://<name> published via the file layer)
  c1 query rates + finished counts per model
  c2 processing-time stats of a query per model
  c4 [path] dump all results to result.txt
  cvm  per-host running tasks
  cq   per-query task assignment map
  train <name> <corpus> <steps> [k=v ...]   background LM training job
       (model: vocab/dim/depth/num_heads; batch_size seq_len lr
        checkpoint_every seed resume=1; place=1 = master-placed,
        auto-resumed on another node if its host dies)
  train-status <name> | train-stop <name>
  lm-serve <name> <prompt_len> <max_len> [k=v ...]  continuous-batching pool
       (slots decode_steps quantize=int8 eos_id=N draft=<lm> draft_len=N;
        draft pools: greedy token-exact, sampled distribution-exact;
        place=1 = cluster-managed: master-placed, requests journaled to
        the standby, pool+requests recovered if its node dies)
  lm-submit <name> <max_new> [temperature= top_p= top_k=
       presence_penalty= frequency_penalty= stop=1,2;9 seed=
       tenant= priority=interactive|batch deadline_ms=]
       <tok> [tok ...]
       queue a prompt -> request id (temperature 0=greedy, >0 sampled;
       top_p<1 = nucleus, top_k>0 = k most probable first; penalties
       need a penalties=1 pool; stop = token sequences, ';'-separated;
       tenant/priority/deadline_ms need a gateway=1 pool — a shed
       request errors here with its reason)
  lm-poll <name> | lm-stats <name> | lm-stop <name>
       fetch completions / occupancy+token counters / stop
  lm-cancel <name> <id>   best-effort cancel (live rows return partials)
  lm-tail <name>          stream view: live rows' tokens so far
       (+ recent gateway sheds with reasons on gateway pools)
  lm-qos <name>           gateway QoS: per-class queue depth,
       admit/shed/expire counters, p50/p99 queue wait, per-tenant rows
       (replica groups: policy, replica roles/states, recent scaling
        decisions, then each replica's gateway block)
  lm-autoscale <name> [k=v ...]   replica-group scaling policy: no args
       = show policy + recent decisions; k=v (deadline_slack_s
       min_replicas max_replicas dwell_s drain_window_s
       prefill_len_threshold prefill_chunk rebalance_debt enabled=0/1)
       = update. Groups come from lm-serve ... autoscale=1 (or
       autoscale.<key>=v for inline policy)
  trace <trace-id> | trace <pool> <req-id> | trace <model> <qnum>
       cluster-wide span waterfall of one request (collected from every
       alive node; one line per span: offset, duration, node, name, attrs)
  metrics [host]          Prometheus text exposition of a node's counters,
       rates, LM/gateway gauges and span-store depth"""


class Shell:
    def __init__(self, node: Node, out: Callable[[str], None] = print,
                 async_inference: bool = True) -> None:
        self.node = node
        self.out = out
        self.async_inference = async_inference
        self._commands = {
            "help": self.cmd_help, "1": self.cmd_list_mem,
            "list_mem": self.cmd_list_mem,
            "2": self.cmd_list_self, "list_self": self.cmd_list_self,
            "3": self.cmd_join, "join": self.cmd_join,
            "4": self.cmd_leave, "leave": self.cmd_leave,
            "5": self.cmd_list_master, "list_master": self.cmd_list_master,
            "6": self.cmd_grep, "grep": self.cmd_grep,
            "7": self.cmd_put, "put": self.cmd_put,
            "8": self.cmd_get, "get": self.cmd_get,
            "9": self.cmd_delete, "delete": self.cmd_delete,
            "10": self.cmd_ls, "ls": self.cmd_ls,
            "11": self.cmd_store, "store": self.cmd_store,
            "12": self.cmd_get_versions, "get-versions": self.cmd_get_versions,
            "13": self.cmd_inference, "inference": self.cmd_inference,
            "c1": self.cmd_c1, "c2": self.cmd_c2, "c4": self.cmd_c4,
            "cvm": self.cmd_cvm, "cq": self.cmd_cq,
            "train": self.cmd_train,
            "train-status": self.cmd_train_status,
            "train-stop": self.cmd_train_stop,
            "lm-serve": self.cmd_lm_serve,
            "lm-submit": self.cmd_lm_submit,
            "lm-poll": self.cmd_lm_poll,
            "lm-stats": self.cmd_lm_stats,
            "lm-stop": self.cmd_lm_stop,
            "lm-cancel": self.cmd_lm_cancel,
            "lm-tail": self.cmd_lm_tail,
            "lm-qos": self.cmd_lm_qos,
            "lm-autoscale": self.cmd_lm_autoscale,
            "trace": self.cmd_trace,
            "metrics": self.cmd_metrics,
        }

    # -- command dispatch -------------------------------------------------

    def dispatch(self, line: str) -> str | None:
        """Run one command line; returns the output text (also emitted)."""
        parts = shlex.split(line.strip())
        if not parts:
            return None
        cmd, args = parts[0], parts[1:]
        fn = self._commands.get(cmd)
        if fn is None:
            text = f"unknown command: {cmd!r} (try `help`)"
        else:
            try:
                text = fn(args)
            except Exception as e:          # shell must survive bad input
                text = f"error: {e}"
        if text:
            self.out(text)
        return text

    def run(self, lines: Iterable[str] | None = None) -> None:
        if lines is None:
            self.out("idunno_tpu shell — `help` for commands")
            while True:
                try:
                    line = input(f"{self.node.host}> ")
                except (EOFError, KeyboardInterrupt):
                    return
                if line.strip() in ("exit", "quit"):
                    return
                self.dispatch(line)
        else:
            for line in lines:
                self.dispatch(line)

    # -- membership -------------------------------------------------------

    def cmd_help(self, args: list[str]) -> str:
        return HELP

    def cmd_list_mem(self, args: list[str]) -> str:
        rows = [f"{e.host:20s} {e.status.value:8s} ts={e.ts:.3f}"
                for e in self.node.membership.members.entries()]
        return "\n".join(rows) or "(empty membership list)"

    def cmd_list_self(self, args: list[str]) -> str:
        me = self.node.membership.members.get(self.node.host)
        status = me.status.value if me else "NOT JOINED"
        return f"{self.node.host} [{status}]"

    def cmd_join(self, args: list[str]) -> str:
        self.node.membership.join()
        return f"{self.node.host} joined"

    def cmd_leave(self, args: list[str]) -> str:
        self.node.leave()
        return f"{self.node.host} left (voluntary)"

    def cmd_list_master(self, args: list[str]) -> str:
        epoch, owner = self.node.membership.epoch.view()
        rows = [f"acting master: {self.node.membership.acting_master()}",
                f"standby:       {self.node.config.standby_coordinator}",
                f"epoch:         {epoch}"
                + (f" (owner {owner})" if owner else " (bootstrap)")]
        # per-scope ownership table: which host serves each
        # managed pool/group scope under rendezvous placement, per this
        # node's gossiped claim map
        owners = getattr(self.node.membership, "owners", None)
        if owners is not None and owners.scopes():
            rows.append("scope owners:")
            for scope in owners.scopes():
                o, seq = owners.view(scope)
                rows.append(f"  {scope} -> {o} (seq {seq})")
        # differential-health table: this node's verdict on
        # every peer it holds a non-HEALTHY verdict for, with the RPC
        # latency EWMA the verdict was derived from
        health = getattr(self.node.membership, "health", None)
        if health is not None:
            table = [(peer, st, ewma) for peer, st, ewma
                     in health.table() if st != "healthy"]
            if table:
                rows.append("peer health:")
                rows.extend(f"  {peer:<12} {st:<12} {ewma * 1000:.1f}ms"
                            for peer, st, ewma in table)
        return "\n".join(rows)

    # -- grep -------------------------------------------------------------

    def cmd_grep(self, args: list[str]) -> str:
        if not args:
            return "usage: grep <pattern>"
        results = self.node.grep.query(" ".join(args))
        out = []
        for h in sorted(results):
            r = results[h]
            if "error" in r:
                out.append(f"--- {h}: ERROR {r['error']}")
                continue
            out.append(f"--- {h}: {r['count']} matching lines"
                       + (" (truncated)" if r.get("truncated") else ""))
            out.extend(r["lines"])
        total = self.node.grep.total_count(results)
        out.append(f"TOTAL: {total} matching lines")
        return "\n".join(out)

    # -- file store -------------------------------------------------------

    def cmd_put(self, args: list[str]) -> str:
        if len(args) != 2:
            return "usage: put <localfilename> <sdfsfilename>"
        v = self.node.store.put(args[0], args[1])
        return f"put {args[1]} -> version {v}"

    def cmd_get(self, args: list[str]) -> str:
        if len(args) != 2:
            return "usage: get <sdfsfilename> <localfilename>"
        v = self.node.store.get(args[0], args[1])
        return f"got {args[0]} (version {v}) -> {args[1]}"

    def cmd_delete(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: delete <sdfsfilename>"
        self.node.store.delete(args[0])
        return f"deleted {args[0]}"

    def cmd_ls(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: ls <sdfsfilename>"
        hosts = self.node.store.ls(args[0])
        return "\n".join(hosts) or f"{args[0]} not stored anywhere"

    def cmd_store(self, args: list[str]) -> str:
        files = self.node.store.local_files()
        rows = [f"{n}  versions={vs}" for n, vs in sorted(files.items())]
        return "\n".join(rows) or "(nothing stored on this host)"

    def cmd_get_versions(self, args: list[str]) -> str:
        if len(args) != 3:
            return "usage: get-versions <sdfsfilename> <num-versions> <localfilename>"
        versions = self.node.store.get_versions(args[0], int(args[1]), args[2])
        return f"wrote versions {versions} of {args[0]} -> {args[2]}"

    # -- inference --------------------------------------------------------

    def cmd_inference(self, args: list[str]) -> str:
        if len(args) not in (3, 4):
            return ("usage: inference <start> <end> <model> [dataset] "
                    "(dataset may be a local dir or store://<name>)")
        start, end, model = int(args[0]), int(args[1]), args[2]
        dataset = args[3] if len(args) == 4 else None
        if self.async_inference:
            # the reference runs the paced query pump in a thread (`:1200-1205`)
            def pump():
                try:
                    self.node.inference.inference(model, start, end,
                                                  dataset=dataset)
                except Exception as e:
                    self.out(f"inference pump {model} [{start}, {end}] "
                             f"aborted: {e}")
            threading.Thread(target=pump, daemon=True,
                             name=f"{self.node.host}-inference-pump").start()
            return (f"submitted inference {model} [{start}, {end}] "
                    f"(paced, 1 query / {self.node.config.query_interval_s:g} s)")
        qnums = self.node.inference.inference(model, start, end, pace_s=0.0,
                                              dataset=dataset)
        return f"submitted inference {model} [{start}, {end}] queries={qnums}"

    # -- stats ------------------------------------------------------------

    def _models_seen(self) -> list[str]:
        return self.node.inference.models_seen()

    def cmd_c1(self, args: list[str]) -> str:
        svc = self.node.inference
        bs = self.node.config.query_batch_size
        rows = []
        for m in self._models_seen():
            rows.append(
                f"{m}: query_rate={svc.metrics.query_rate(m, bs):.3f}/s "
                f"image_rate={svc.metrics.image_rate(m):.1f}/s "
                f"finished_images={svc.metrics.finished_images(m)} "
                f"finished_queries={svc.metrics.finished_queries(m)}")
        # heterogeneous fair share: how the worker units currently divide
        # between CNN query jobs and LM decode pools (measured rates)
        mgr = getattr(self.node, "lm_manager", None)
        if mgr is not None and mgr.managed_pools():
            view = mgr.allocation_view()
            rows.append(f"fair share (rate_factor={view['rate_factor']}, "
                        f"workers={view['n_workers']}):")
            for job, d in sorted(view["jobs"].items()):
                meas = (f"avg_query_s={d['avg_query_s']}"
                        if "avg_query_s" in d else
                        f"avg_request_s={d['avg_request_s']} "
                        f"avg_token_s={d['avg_token_s']} "
                        f"slots={d['slots']}")
                rows.append(f"  {job}: {meas} share={d['share']}")
        return "\n".join(rows) or "(no queries yet)"

    def cmd_c2(self, args: list[str]) -> str:
        svc = self.node.inference
        prov = svc.weights_provenance()
        rows = []
        for m in self._models_seen():
            s = svc.metrics.processing_stats(m)
            w = prov.get(m, "unknown")
            if s is None:
                rows.append(f"{m}: (no data in window) weights={w}")
            else:
                rows.append(f"{m}: avg={s.avg:.3f}s q1={s.q1:.3f}s "
                            f"median={s.q2:.3f}s q3={s.q3:.3f}s "
                            f"stddev={s.stddev:.3f}s n={s.n} weights={w}")
        return "\n".join(rows) or "(no queries yet)"

    def cmd_c4(self, args: list[str]) -> str:
        svc = self.node.inference
        results = svc.all_results()
        prov = svc.weights_provenance()
        path = args[0] if args else "result.txt"
        # flat {"model qnum": records} map — the reference's c4 contract
        # (`:1208-1211`); provenance goes to the shell line only, so file
        # consumers that iterate entries see records and nothing else.
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
        n = sum(len(v) for v in results.values())
        wdesc = ", ".join(f"{m}={w}" for m, w in sorted(prov.items()))
        return (f"wrote {n} records across {len(results)} queries -> {path}"
                + (f" (weights: {wdesc})" if wdesc else ""))

    def cmd_cvm(self, args: list[str]) -> str:
        book = self.node.inference.scheduler.book
        rows = []
        for h in self.node.membership.members.alive_hosts():
            tasks = [t for t in book.tasks_on_worker(h) if t.state == "w"]
            desc = ", ".join(f"{t.model}#{t.qnum}[{t.start},{t.end}]"
                             for t in tasks) or "(idle)"
            rows.append(f"{h}: {desc}")
        return "\n".join(rows) or "(no members)"

    def cmd_cq(self, args: list[str]) -> str:
        book = self.node.inference.scheduler.book
        rows = []
        for model, qnum in book.queries():
            parts = ", ".join(
                f"({t.worker},{t.start},{t.end},{t.state})"
                for t in book.tasks_for_query(model, qnum))
            rows.append(f"{model}#{qnum}: {parts}")
        return "\n".join(rows) or "(no queries yet)"

    # -- LM training / serving (the control verbs, local) -----------------

    _MODEL_KEYS = ("vocab", "dim", "depth", "num_heads")
    _TRAIN_KEYS = ("batch_size", "seq_len", "checkpoint_every", "seed")

    @staticmethod
    def _kv(args: list[str]) -> dict:
        out = {}
        for a in args:
            if "=" not in a:
                raise ValueError(f"expected key=value, got {a!r}")
            k, v = a.split("=", 1)
            out[k] = v
        return out

    def _control(self, verb: str, **payload) -> dict:
        return self.node.control._dispatch(verb, payload)

    def cmd_train(self, args: list[str]) -> str:
        if len(args) < 3:
            return ("usage: train <name> <corpus> <steps> [vocab= dim= "
                    "depth= num_heads= batch_size= seq_len= lr= "
                    "checkpoint_every= seed= resume=1]")
        name, corpus, steps = args[0], args[1], int(args[2])
        kv = self._kv(args[3:])
        model = {k: int(kv.pop(k)) for k in self._MODEL_KEYS if k in kv}
        payload = {k: int(kv.pop(k)) for k in self._TRAIN_KEYS if k in kv}
        if "lr" in kv:
            payload["lr"] = float(kv.pop("lr"))
        if "resume" in kv:
            payload["resume"] = kv.pop("resume") not in ("0", "false", "")
        if "place" in kv and kv.pop("place") not in ("0", "false", ""):
            payload["placement"] = "auto"   # master-placed, auto-resumed
        if kv:
            return f"unknown train option(s): {sorted(kv)}"
        out = self._control("train_start", name=name, corpus=corpus,
                            steps=steps, model=model, **payload)
        where = f" on {out['node']}" if out.get("node") else ""
        return (f"training job {name} started{where} "
                f"({steps} steps on {corpus})")

    def cmd_train_status(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: train-status <name>"
        st = self._control("train_status", name=args[0])
        loss = "-" if st["loss"] is None else f"{st['loss']:.4f}"
        state = ("ERROR: " + st["error"] if st["error"] else
                 "done" if st["done"] else
                 "stopped" if st["stopped"] else "running")
        return (f"{args[0]}: step={st['step']} loss={loss} {state} "
                f"ckpt_v={st['checkpoint_version']} "
                f"served_v={st['served_version']}")

    def cmd_train_stop(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: train-stop <name>"
        out = self._control("train_stop", name=args[0])
        if not out["stopped"]:
            return f"no training job {args[0]}"
        return f"stopped {args[0]} at step {out['status']['step']}"

    def cmd_lm_serve(self, args: list[str]) -> str:
        if len(args) < 3:
            return ("usage: lm-serve <name> <prompt_len> <max_len> "
                    "[slots= decode_steps= quantize=int8 "
                    "kv_cache_dtype=int8 eos_id=N logprobs=1 penalties=1 "
                    "prefix=7,2,19 kv_block_size=N kv_cache_blocks=N "
                    "draft=<lm> draft_len=N place=1 reload=1 "
                    "gateway=1 quota=tenant:rate:burst:weight[;...] "
                    "gw_queue=N]\n"
                    "note: draft (speculative) pools serve greedy "
                    "requests token-exact and sampled requests "
                    "distribution-exact (speculative sampling); "
                    "kv_block_size>0 enables the paged cross-request "
                    "prefix cache (token-exact, block-aligned hits); "
                    "gateway=1 puts the QoS admission gateway in front "
                    "(quota rate '-' = unlimited)")
        kv = self._kv(args[3:])
        payload = {k: int(kv.pop(k))
                   for k in ("slots", "decode_steps", "eos_id",
                             "draft_len", "kv_block_size",
                             "kv_cache_blocks") if k in kv}
        if "quantize" in kv:
            payload["quantize"] = kv.pop("quantize")
        if "kv_cache_dtype" in kv:
            payload["kv_cache_dtype"] = kv.pop("kv_cache_dtype")
        if "draft" in kv:
            payload["draft"] = kv.pop("draft")
        if "place" in kv and kv.pop("place") not in ("0", "false", ""):
            # cluster-managed pool: the acting master places it on the
            # least-loaded node, journals requests, and recovers it (with
            # its unfinished requests) if its node dies
            payload["placement"] = "auto"
        if "logprobs" in kv:
            payload["track_logprobs"] = kv.pop("logprobs") not in (
                "0", "false", "")
        if "penalties" in kv:
            payload["penalties"] = kv.pop("penalties") not in (
                "0", "false", "")
        if "prefix" in kv:   # shared system-prompt tokens, comma-separated
            payload["prefix"] = [int(t)
                                 for t in kv.pop("prefix").split(",") if t]
        if "reload" in kv:
            payload["reload"] = kv.pop("reload") not in ("0", "false", "")
        gw: dict | None = None
        if "gateway" in kv and kv.pop("gateway") not in ("0", "false", ""):
            gw = {}
        if "quota" in kv:   # quota=t1:5:10:2;t2:-:4:1  (rate '-'=unlimited)
            gw = gw if gw is not None else {}
            tenants = {}
            for part in kv.pop("quota").split(";"):
                if not part:
                    continue
                t, rate, burst, weight = part.split(":")
                tenants[t] = {"rate": None if rate == "-" else float(rate),
                              "burst": float(burst),
                              "weight": float(weight)}
            gw["tenants"] = tenants
        if "gw_queue" in kv:
            gw = gw if gw is not None else {}
            gw["max_queue"] = int(kv.pop("gw_queue"))
        if gw is not None:
            payload["gateway"] = gw
        auto: dict | None = None
        if "autoscale" in kv and kv.pop("autoscale") not in (
                "0", "false", ""):
            auto = {}
        for k in [k for k in kv if k.startswith("autoscale.")]:
            # inline policy knobs: autoscale.max_replicas=3 ...
            auto = auto if auto is not None else {}
            key, raw = k.split(".", 1)[1], kv.pop(k)
            auto[key] = (raw not in ("0", "false", "")
                         if key == "enabled" else
                         int(raw) if key in (
                             "min_replicas", "max_replicas",
                             "prefill_len_threshold", "prefill_chunk")
                         else float(raw))
        if auto is not None:
            # a replica group is cluster state by definition — it only
            # exists behind the acting master's manager
            payload["autoscale"] = auto
            payload["placement"] = "auto"
        if kv:
            return f"unknown lm-serve option(s): {sorted(kv)}"
        out = self._control("lm_serve", name=args[0],
                            prompt_len=int(args[1]), max_len=int(args[2]),
                            **payload)
        if out.get("already"):
            return f"{args[0]} already serving (pass reload=1 to restart)"
        if out.get("group"):
            return (f"serving group {args[0]} with replicas "
                    f"{', '.join(out.get('replicas', []))}")
        where = f" on {out['node']}" if out.get("node") else ""
        return f"serving {args[0]} with {out['slots']} slots{where}"

    def cmd_lm_autoscale(self, args: list[str]) -> str:
        if not args:
            return ("usage: lm-autoscale <group> [deadline_slack_s= "
                    "min_replicas= max_replicas= dwell_s= drain_window_s= "
                    "scale_in_frac= prefill_len_threshold= prefill_chunk= "
                    "prefill_share= rebalance_debt= enabled=0/1]")
        kv = self._kv(args[1:])
        updates: dict = {}
        for k, raw in kv.items():
            if k == "enabled":
                updates[k] = raw not in ("0", "false", "")
            elif k in ("min_replicas", "max_replicas",
                       "prefill_len_threshold", "prefill_chunk"):
                updates[k] = int(raw)
            else:
                updates[k] = float(raw)
        if updates:
            out = self._control("lm_autoscale", name=args[0],
                                policy=updates)
            pol = out["policy"]
        else:
            out = self._control("lm_autoscale", name=args[0])
            pol = out["policy"]
        rows = [f"{args[0]}: " + " ".join(
            f"{k}={pol[k]}" for k in sorted(pol))]
        for r, m in sorted(out.get("replicas", {}).items()):
            rows.append(f"  replica {r}: role={m.get('role')} "
                        f"state={m.get('state')}")
        for d in out.get("decisions", []):
            extra = d.get("replica") or d.get("tenant") or ""
            rows.append(f"  decision #{d['seq']}: {d['action']} {extra} "
                        f"(epoch={d['epoch'][0]}, t={d['t']:.2f})")
        return "\n".join(rows)

    def cmd_lm_submit(self, args: list[str]) -> str:
        if len(args) < 3:
            return ("usage: lm-submit <name> <max_new> "
                    "[temperature= top_p= top_k= presence_penalty= "
                    "frequency_penalty= stop=1,2;9 seed=] <tok> [tok ...]")
        kv = self._kv([a for a in args[2:] if "=" in a])
        toks = [int(t) for t in args[2:] if "=" not in t]
        payload = {}
        if "temperature" in kv:
            payload["temperature"] = float(kv.pop("temperature"))
        if "top_p" in kv:
            payload["top_p"] = float(kv.pop("top_p"))
        if "top_k" in kv:
            payload["top_k"] = int(kv.pop("top_k"))
        for pk in ("presence_penalty", "frequency_penalty"):
            if pk in kv:
                payload[pk] = float(kv.pop(pk))
        if "stop" in kv:   # stop=1,2;9 -> sequences [1,2] and [9]
            payload["stop"] = [[int(t) for t in seq.split(",") if t]
                               for seq in kv.pop("stop").split(";") if seq]
        if "seed" in kv:
            payload["seed"] = int(kv.pop("seed"))
        if "tenant" in kv:
            payload["tenant"] = kv.pop("tenant")
        if "priority" in kv:
            payload["priority"] = kv.pop("priority")
        if "deadline_ms" in kv:
            payload["deadline_ms"] = float(kv.pop("deadline_ms"))
        if kv:
            return f"unknown lm-submit option(s): {sorted(kv)}"
        out = self._control("lm_submit", name=args[0],
                            max_new=int(args[1]), prompt=toks, **payload)
        return f"request {out['id']} queued on {args[0]}"

    def cmd_lm_poll(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: lm-poll <name>"
        out = self._control("lm_poll", name=args[0])
        rows = [f"#{c['id']}: {' '.join(str(t) for t in c['tokens'])} "
                f"(prompt_len={c['prompt_len']}"
                + (", CANCELLED" if c.get("cancelled") else "")
                + (f", {c['rejected'].upper()}" if c.get("rejected")
                   else "") + ")"
                for c in out["completions"]]
        rows.extend(f"#{rid}: CANCELLED"
                    for rid in out.get("cancelled", []))
        rows.extend(f"#{s['id']}: SHED ({s['reason']})"
                    for s in out.get("shed", []))
        rows.extend(f"#{rid}: EXPIRED"
                    for rid in out.get("expired", []))
        rows.extend(f"ERROR: {e}" for e in out.get("errors", []))
        return "\n".join(rows) or "(no completions yet)"

    def cmd_lm_cancel(self, args: list[str]) -> str:
        if len(args) != 2:
            return "usage: lm-cancel <name> <id>"
        out = self._control("lm_cancel", name=args[0], id=int(args[1]))
        return (f"cancelled #{args[1]}" if out["cancelled"]
                else f"#{args[1]} not cancellable (done or unknown)")

    def cmd_lm_tail(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: lm-tail <name>"
        out = self._control("lm_partial", name=args[0])
        rows = [f"#{r['id']}: {' '.join(str(t) for t in r['tokens'])} "
                f"({len(r['tokens']) - r['prompt_len']} generated)"
                + (f" trace={r['trace']}" if r.get("trace") else "")
                for r in out["partial"]]
        rows.extend(f"shed: tenant={s['tenant']} {s['priority']} "
                    f"[{s['reason']}] {s['detail']}"
                    for s in out.get("sheds", []))
        if out.get("error"):
            rows.append(f"ERROR: {out['error']}")
        return "\n".join(rows) or "(no live rows)"

    def cmd_lm_stats(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: lm-stats <name>"
        s = self._control("lm_stats", name=args[0])["stats"]

        def config_line(stats: dict) -> str:
            cfg = stats.get("config")
            if not cfg:
                return ""
            return (f"\n  serving: {cfg['dim']}d x {cfg['depth']}L "
                    f"heads={cfg['heads']}/{cfg['kv_heads']}kv "
                    f"kv_cache={cfg['kv_cache_dtype']} "
                    f"weights={cfg['quantize']} "
                    f"decode_steps={cfg['decode_steps']}"
                    + (f" draft_len={cfg['speculative_draft_len']}"
                       if cfg["speculative_draft_len"] else "")
                    + (f" n_model={cfg['n_model']} "
                       f"tp_bytes/step={cfg['tp_collective_bytes']}"
                       if cfg.get("n_model", 1) > 1 else ""))

        def prefix_line(stats: dict) -> str:
            pc = stats.get("prefix_cache")
            if not pc:
                return ""
            out = (f"\n  prefix_cache: hit_rate="
                   f"{pc['prefix_hit_rate']:.2f} "
                   f"saved={pc['cached_tokens_saved']}tok "
                   f"blocks={pc['kv_blocks_used']}/"
                   f"{pc['kv_blocks_used'] + pc['kv_blocks_free']} "
                   f"evictions={pc['evictions']}")
            # cluster tier: only worth a line once the ring
            # has been touched — published, hit, warmed or fetched
            if any(pc.get(k) for k in ("prefix_remote_hits",
                                       "prefix_published_chains",
                                       "prefix_warm_blocks",
                                       "prefix_fetch_bytes")):
                out += (f"\n  cluster_prefix: remote_hits="
                        f"{pc['prefix_remote_hits']} "
                        f"published={pc['prefix_published_chains']} "
                        f"warm_blocks={pc['prefix_warm_blocks']} "
                        f"fetched={pc['prefix_fetch_bytes']}B")
            return out

        def handoff_line(stats: dict) -> str:
            # DistServe handoff: only worth a line once a
            # ship has moved bytes or a fallback fired
            if not any(stats.get(k) for k in ("kv_handoff_requests",
                                              "kv_handoff_bytes",
                                              "kv_handoff_fallbacks")):
                return ""
            return (f"\n  kv_handoff: ships={stats['kv_handoff_requests']} "
                    f"bytes={stats['kv_handoff_bytes']} "
                    f"fallbacks={stats['kv_handoff_fallbacks']}")

        def gateway_line(stats: dict) -> str:
            gw = stats.get("gateway")
            if not gw:
                return ""
            parts = []
            for cname, c in sorted(gw["classes"].items()):
                w = c["queue_wait_s"]
                parts.append(
                    f"{cname}: q={c['queued']} "
                    f"shed={sum(c['shed'].values())} "
                    f"expired={c['expired']} "
                    f"reject_rate={c['reject_rate']:.2f} "
                    f"wait_p99={w['p99'] * 1000:.0f}ms")
            return "\n  gateway: " + " | ".join(parts)

        if "journal" in s:              # cluster-managed pool
            j = s["journal"]
            head = (f"{args[0]}: node={s['node']} "
                    f"pending={j['pending']} inflight={j['inflight']} "
                    f"done={j['done']} failed={j['failed']}"
                    + (f" cancelled={j['cancelled']}"
                       if j.get("cancelled") else "")
                    + (f" shed={j['shed']}" if j.get("shed") else "")
                    + (f" expired={j['expired']}"
                       if j.get("expired") else ""))
            p = s.get("pool")
            if not p:
                return head + f" (pool: {s.get('pool_error', 'n/a')})"
            return (head + f" | live={p['live']}/{p['slots']} "
                    f"completed={p['completed']} "
                    f"tokens_generated={p['tokens_generated']}"
                    + config_line(p) + prefix_line(p) + handoff_line(p)
                    + gateway_line(p))
        return (f"{args[0]}: live={s['live']}/{s['slots']} "
                f"queued={s['queued']} inbox={s['inbox']} "
                f"unpolled={s['unpolled']} admitted={s['admitted']} "
                f"completed={s['completed']} "
                f"tokens_generated={s['tokens_generated']} "
                f"dispatches={s['dispatches']}" + config_line(s)
                + prefix_line(s) + handoff_line(s) + gateway_line(s))

    def cmd_lm_qos(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: lm-qos <name>"
        out = self._control("lm_qos", name=args[0])
        head = []
        owners = getattr(self.node.membership, "owners", None)
        if owners is not None:
            from idunno_tpu_torch.membership.epoch import pool_scope
            view = owners.view(pool_scope(args[0]))
            if view is not None:
                head.append(f"{args[0]}: scope {pool_scope(args[0])} "
                            f"owned by {view[0]} (seq {view[1]})")
        grp = out.get("group")
        if grp is not None:             # autoscaled replica group
            pol = grp.get("policy", {})
            rows = [f"{args[0]}: replica group "
                    f"(slack={pol.get('deadline_slack_s')}s "
                    f"min={pol.get('min_replicas')} "
                    f"max={pol.get('max_replicas')} "
                    f"dwell={pol.get('dwell_s')}s "
                    f"enabled={pol.get('enabled')})"]
            fc = grp.get("forecast") or {}
            if fc.get("predicted_rate") or fc.get("predictive_spawns"):
                rows.append(
                    f"  forecast: predicted_rate="
                    f"{fc['predicted_rate']:.2f}/s "
                    f"predictive_spawns={fc['predictive_spawns']}")
            for r, m in sorted(grp.get("replicas", {}).items()):
                rows.append(f"  replica {r}: role={m.get('role')} "
                            f"state={m.get('state')}")
            for d in grp.get("decisions", []):
                extra = d.get("replica") or d.get("tenant") or ""
                rows.append(f"  decision #{d['seq']}: {d['action']} "
                            f"{extra} (epoch={d['epoch'][0]})")
            for r, rq in sorted(out.get("replicas", {}).items()):
                rows.append(self._fmt_qos(r, rq))
            return "\n".join(head + rows)
        return "\n".join(head + [self._fmt_qos(args[0], out)])

    def _fmt_qos(self, name: str, out: dict) -> str:
        rows = []
        if "journal" in out:            # cluster-managed pool
            j = out["journal"]
            rows.append(f"{name}: node={out['node']} journal: "
                        f"done={j['done']} shed={j['shed']} "
                        f"expired={j['expired']} "
                        f"cancelled={j['cancelled']}")
            if out.get("qos_error"):
                rows.append(f"  (gateway: {out['qos_error']})")
        q = out.get("qos")
        if q is None:
            rows.append(f"  (no gateway on {name})")
            return "\n".join(rows)
        rows.append(f"  queued={q['queued']}/{q['max_queue']}")
        for cname, c in sorted(q["classes"].items()):
            w = c["queue_wait_s"]
            sheds = " ".join(f"{r}={n}" for r, n in sorted(c["shed"].items())
                             if n)
            rows.append(
                f"  {cname}: queued={c['queued']} admitted={c['admitted']} "
                f"dispatched={c['dispatched']} expired={c['expired']}"
                + (f" shed[{sheds}]" if sheds else "")
                + f" reject_rate={c['reject_rate']:.2f}"
                  f" wait_p50={w['p50'] * 1000:.0f}ms"
                  f" wait_p99={w['p99'] * 1000:.0f}ms (n={w['n']})")
        for t, c in sorted(q["tenants"].items()):
            rate = "-" if c["rate"] is None else f"{c['rate']:g}"
            rows.append(
                f"  tenant {t}: queued={c['queued']} "
                f"admitted={c['admitted']} dispatched={c['dispatched']} "
                f"shed={c['shed']} expired={c['expired']} "
                f"rate={rate} burst={c['burst']:g} weight={c['weight']:g}")
        return "\n".join(rows)

    def cmd_lm_stop(self, args: list[str]) -> str:
        if len(args) != 1:
            return "usage: lm-stop <name>"
        out = self._control("lm_stop", name=args[0])
        return (f"stopped {args[0]}" if out["stopped"]
                else f"no serving pool {args[0]}")

    # -- observability ----------------------------------------------------

    def cmd_trace(self, args: list[str]) -> str:
        if len(args) not in (1, 2):
            return ("usage: trace <trace-id> | trace <pool> <req-id> | "
                    "trace <model> <qnum>")
        if len(args) == 1:
            out = self._control("trace", trace_id=args[0])
        else:
            try:        # LM pool request first, CNN query as the fallback
                out = self._control("trace", name=args[0], id=int(args[1]))
            except Exception:
                out = self._control("trace", model=args[0],
                                    qnum=int(args[1]))
        return format_waterfall(out["trace_id"], out["spans"])

    def cmd_metrics(self, args: list[str]) -> str:
        if len(args) > 1:
            return "usage: metrics [host]"
        out = self._control("metrics_export",
                            **({"host": args[0]} if args else {}))
        return out["text"].rstrip("\n")


def format_waterfall(trace_id: str, spans: list[dict]) -> str:
    """One line per span — offset from the trace start, duration, node,
    depth-indented name, then the attrs. Shared by the shell `trace`
    command and idunno_tpu_torch/tools/trace_export.py."""
    if not spans:
        return f"(no spans recorded for {trace_id})"
    base = min(s["t_start"] for s in spans)
    by_id = {s["span_id"]: s for s in spans}

    def depth(s: dict) -> int:
        d, seen = 0, set()
        while s.get("parent") in by_id and s["span_id"] not in seen:
            seen.add(s["span_id"])
            s = by_id[s["parent"]]
            d += 1
        return d

    rows = [f"trace {trace_id} ({len(spans)} spans)"]
    for s in spans:
        t0 = s["t_start"] - base
        dur = ((s["t_end"] - s["t_start"]) * 1000.0
               if s.get("t_end") is not None else None)
        attrs = " ".join(f"{k}={v}" for k, v in sorted(
            (s.get("attrs") or {}).items()))
        rows.append(f"{t0 * 1000.0:9.2f}ms "
                    + (f"{dur:9.2f}ms " if dur is not None
                       else f"{'open':>9s}   ")
                    + f"{s['node']:<12s} "
                    + "  " * depth(s) + s["name"]
                    + (f"  [{attrs}]" if attrs else ""))
    return "\n".join(rows)
