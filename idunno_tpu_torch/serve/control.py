"""Remote control/status RPC — drive a node from OUTSIDE its process.

A port of ``idunno_tpu/serve/control.py``: every verb is the JAX
package's, except that ``generate``, ``lm_serve``, the cluster prefix and
KV-handoff verbs and ``train_start`` run the port's ``load_lm``,
``generate``/``beam_search``, ``DecodeServer``, ``ClusterPrefixCache`` and
``LMTrainJob`` on the node's device (``node.device``: the card unless the
node was built for the CPU), and ``profile`` traces through
``utils/tracing.py`` (``torch.profiler``). ``lm_serve``'s ``n_model > 1``
serves a tensor-parallel pool over a mesh of the node's local devices:
its cards on a card node (one per shard), a virtual mesh over the CPU on
a CPU node (`engine/serve_lm.py`).

The reference is driven only by a human typing into each VM's interactive
shell (`mp4_machinelearning.py:1111-1229`); there is no way to script the
cluster from another process. This service exposes the same verb surface
over the typed transport, so deployment tooling, integration tests and a
remote CLI can run the shell's commands against any node:

  status                     — membership view, acting master, loaded models
  put/get/ls/store/delete    — the SDFS verbs (C4) executed by this node
  inference                  — submit a query range (paced chunking like the
                               shell's `inference` verb, C11)
  query_done / results       — poll completion and fetch accumulated records
                               (the master's c4 view, C9/C12)
  stats / grep               — remote c1/c2 percentiles; distributed log grep
  generate                   — one-shot batch decode of a store-persisted LM
  lm_serve/lm_submit/lm_poll/lm_stop
                             — continuous-batching decode pool per LM
                               (engine/serve_lm.py via serve/lm_pool.py)
  lm_qos                     — QoS gateway observability (queue depths,
                               admit/shed counters, queue-wait
                               percentiles; serve/gateway.py). For a
                               replica group, includes the group block
                               (policy, replica roles/states, recent
                               scaling decisions)
  lm_autoscale               — replica-group scaling policy get/set
                               (serve/autoscaler.py; acting master)
  prefix_publish/prefix_probe/prefix_fetch
                             — the cluster prefix cache of a pool
                               (serve/cluster_prefix.py)
  kv_handoff                 — prefill → decode KV block handoff legs
  profile                    — a torch.profiler trace of the node for a
                               window of seconds (utils/tracing.py)
  train_start/train_status/train_stop
                             — background cluster training jobs
                               (engine/train_job.py; checkpoints + servable
                               LM published into the replicated store)

One request/one reply on the existing node transport; `comm.net.oneshot_call`
is the matching client side (no listener needed).
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING

from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.transport import TransportError
from idunno_tpu_torch.engine.serve_lm import DEFAULT_SLOTS, DecodeServer
from idunno_tpu_torch.membership.epoch import (ScopeOwnerRedirect,
                                               check_payload, check_scoped,
                                               observe_payload, place_scope,
                                               pool_scope)
from idunno_tpu_torch.utils.spans import stamp_trace, trace_from_payload
from idunno_tpu_torch.utils.types import MessageType

if TYPE_CHECKING:                                    # pragma: no cover
    from idunno_tpu_torch.serve.node import Node

SERVICE = "control"


class RelayedError(Exception):
    """An ERROR reply from a forwarded owner hop, relayed VERBATIM: the
    payload keeps its typed markers (``stale_epoch``, ``scope``,
    ``scope_owner``, ``scope_epoch``) so a client behind the proxy hop
    still sees the typed error — its retry/re-route logic must not be
    blinded by a flattened string."""

    def __init__(self, payload: dict) -> None:
        super().__init__(payload.get("error", "relayed error"))
        self.payload = dict(payload)


class _Starting:
    """Registry placeholder while an `lm_serve` builds its pool outside the
    lock — reserves the name without blocking other verbs."""


class ControlService:
    def __init__(self, node: "Node") -> None:
        import threading

        self.node = node
        self._lms: dict = {}          # name -> TransformerLM, loaded once
        self._lm_loops: dict = {}     # name -> LMServingLoop (continuous)
        self._train_jobs: dict = {}   # name -> LMTrainJob
        # (name, idem key) -> node-local row id: dedupes a manager's
        # RE-forward of an lm_submit whose ACK was lost, so the retried
        # request decodes exactly once on this node. Purged per name on
        # lm_serve rebuild / lm_stop — after a rebuild the old row ids
        # are dead, replaying them would map retries onto a new loop's
        # unrelated rows
        self._lm_idem: dict = {}
        # transports run one handler thread per connection: registry
        # check-then-act must be atomic or two concurrent lm_serve/
        # train_start calls each spawn a loop and one leaks unjoinable
        self._reg_lock = threading.Lock()
        node.transport.serve(SERVICE, self._handle)

    def close(self) -> None:
        with self._reg_lock:
            loops = list(self._lm_loops.values())
            self._lm_loops.clear()
            jobs = list(self._train_jobs.values())
            self._train_jobs.clear()
        for loop in loops:
            if not isinstance(loop, _Starting):
                loop.stop()
        for job in jobs:
            job.stop()

    def _handle(self, service: str, msg: Message) -> Message:
        # epoch fence (membership/epoch.py): control verbs stamped by a
        # deposed coordinator are rejected with a typed stale-epoch ERROR
        # before they can mutate anything; unstamped payloads (clients,
        # pre-failover traffic) pass and current stamps advance the local
        # high-water mark
        stale = check_payload(self.node.membership.epoch, msg.payload,
                              self.node.host)
        if stale is not None:
            self.node.metrics.record_counter("stale_epoch_rejected")
            return stale
        # per-pool fence: a verb stamped by a deposed POOL
        # owner is rejected for that scope only — the cluster fence above
        # is untouched, so the sender steps down per pool, not globally
        stale = check_scoped(self.node.membership.scopes, msg.payload,
                             self.node.host)
        if stale is not None:
            self.node.metrics.record_counter("stale_scope_rejected")
            return stale
        try:
            out = self._dispatch(msg.payload.get("verb", ""), msg.payload)
            return Message(MessageType.ACK, self.node.host, out)
        except ScopeOwnerRedirect as e:
            # typed not-owner redirect: the reply names the
            # scope's owner so the CLIENT re-sends there directly — one
            # hop, counted; server-side forwarding already absorbed the
            # common case, this is the loop-stop for a stale owner map
            self.node.metrics.record_counter("scope_owner_redirects")
            return Message(MessageType.ERROR, self.node.host,
                           {"error": str(e), "scope": e.scope,
                            "scope_owner": e.owner})
        except RelayedError as e:
            # forwarded owner answered with a typed error: pass the
            # payload through untouched so markers survive the hop
            return Message(MessageType.ERROR, self.node.host, e.payload)
        except Exception as e:  # noqa: BLE001 - RPC boundary: report, don't die
            return Message(MessageType.ERROR, self.node.host,
                           {"error": f"{type(e).__name__}: {e}"})

    def _dispatch(self, verb: str, p: dict) -> dict:
        node = self.node
        routed = self._route_cluster(verb, p)
        if routed is not None:
            return routed
        if verb == "status":
            members = {e.host: e.status.value
                       for e in node.membership.members.entries()}
            return {"host": node.host,
                    # the node's device (the card unless built for the CPU)
                    "device": str(node.device),
                    "acting_master": node.membership.acting_master(),
                    "fence": list(node.membership.epoch.view()),
                    "counters": node.metrics.counters(),
                    "members": members,
                    "models": node.engine.loaded_models()
                    if hasattr(node.engine, "loaded_models") else []}
        if verb == "put":
            version = node.store.put(p["local"], p["name"])
            return {"version": version}
        if verb == "put_bytes":
            version = node.store.put_bytes(
                p["name"], p["data"].encode("latin-1"))
            return {"version": version}
        if verb == "get":
            version = node.store.get(p["name"], p["local"])
            return {"version": version,
                    "size": os.path.getsize(p["local"])}
        if verb == "get_bytes":
            blob, version = node.store.get_bytes(p["name"])
            return {"version": version, "data": blob.decode("latin-1")}
        if verb == "ls":
            return {"hosts": node.store.ls(p["name"])}
        if verb == "store":
            return {"files": node.store.local_files()}
        if verb == "delete":
            node.store.delete(p["name"])
            return {}
        if verb == "inference":
            qnums = node.inference.inference(
                p["model"], int(p["start"]), int(p["end"]),
                pace_s=float(p.get("pace_s", 0.0)),
                dataset=p.get("dataset"))
            return {"qnums": qnums}
        if verb == "query_done":
            return {"done": node.inference.query_done(p["model"],
                                                      int(p["qnum"])),
                    "failed": node.inference.query_failed(p["model"],
                                                          int(p["qnum"]))}
        if verb == "results":
            recs = node.inference.results(p["model"], int(p["qnum"]))
            return {"records": [list(r) for r in recs],
                    "weights": node.inference.weights_provenance()}
        if verb == "stats":
            # remote c1/c2: per-model rates, counts, processing percentiles
            # and the weights-provenance marker
            m = node.metrics
            models = p.get("models")
            if isinstance(models, str):            # scalar like other verbs
                models = [models]
            loaded = getattr(node.engine, "loaded_models", lambda: [])
            provenance = node.inference.weights_provenance()
            out = {}
            for model in (models or node.inference.models_seen()
                          or loaded()):
                ps = m.processing_stats(model)
                out[model] = {
                    "query_rate": m.query_rate(
                        model, node.config.query_batch_size),
                    "image_rate": m.image_rate(model),
                    "finished_images": m.finished_images(model),
                    "finished_queries": m.finished_queries(model),
                    "processing": ps.as_list() if ps else None,
                    "weights": provenance.get(model, "unknown"),
                }
            reply = {"stats": out}
            mgr = getattr(node, "lm_manager", None)
            if mgr is not None and mgr.managed_pools():
                # heterogeneous fair-share arbitration (CNN jobs vs LM
                # pools, measured per-query/per-request rates)
                reply["allocation"] = mgr.allocation_view()
            return reply
        if verb == "grep":
            return {"matches": node.grep.query(p["pattern"])}
        if verb == "generate":
            # serve a store-persisted LM: load once per node onto the
            # node's device (pass reload=true after re-saving a model to
            # refresh the cache), KV-cached decode on every call
            # (engine/generate.py)
            import torch

            from idunno_tpu_torch.engine.generate import (beam_search,
                                                          generate, load_lm)

            name = p["name"]
            with self._reg_lock:
                model = None if p.get("reload") else self._lms.get(name)
            if model is None:
                model = load_lm(node.store, name, device=node.device)
                with self._reg_lock:
                    self._lms[name] = model
            prompt = torch.tensor(p["prompt"], dtype=torch.int64,
                                  device=node.device)
            temperature = float(p.get("temperature", 0.0))
            beam_width = int(p.get("beam_width", 0))
            if beam_width >= 1:       # width 1 is valid (greedy + scores)
                # disabled-sampler values (temperature 0, top_p 1, top_k
                # 0) are fine alongside beam; ACTIVE samplers are not
                if (temperature > 0.0 or float(p.get("top_p", 1.0)) < 1.0
                        or int(p.get("top_k", 0)) > 0
                        or float(p.get("presence_penalty", 0.0)) != 0.0
                        or float(p.get("frequency_penalty", 0.0)) != 0.0):
                    raise ValueError("beam_width is a search, not a "
                                     "sampler: temperature/top_p/top_k/"
                                     "penalties don't apply")
                if p.get("prompt_lens") is not None:
                    raise ValueError("beam_search does not support ragged "
                                     "prompt_lens; pad per-call or use "
                                     "the sampler path")
                seqs, scores = beam_search(model, prompt,
                                           prompt_len=prompt.shape[1],
                                           max_new=int(p["max_new"]),
                                           beam_width=beam_width)
                return {"tokens": seqs.tolist(),
                        "log_probs": [float(s) for s in scores.tolist()]}
            kw = {}
            if p.get("prompt_lens") is not None:
                kw["prompt_lens"] = torch.tensor(p["prompt_lens"],
                                                 dtype=torch.int64)
            seed = p.get("seed")
            if seed is None and temperature > 0.0:
                # RPC callers expect varied samples; never fall through to
                # the library's deterministic default seed
                import secrets
                seed = secrets.randbits(63)
            if seed is not None:
                kw["rng"] = torch.Generator(
                    device=node.device).manual_seed(int(seed))
            out = generate(model, prompt,
                           prompt_len=prompt.shape[1],
                           max_new=int(p["max_new"]),
                           temperature=temperature,
                           top_p=float(p.get("top_p", 1.0)),
                           top_k=int(p.get("top_k", 0)),
                           presence_penalty=float(
                               p.get("presence_penalty", 0.0)),
                           frequency_penalty=float(
                               p.get("frequency_penalty", 0.0)), **kw)
            # .tolist() gives Python ints: replies cross a JSON wire
            return {"tokens": out.tolist()}
        if verb == "lm_serve":
            # continuous-batching serving of a store-persisted LM: a decode
            # pool with `slots` rows on the node's device; requests stream
            # in via lm_submit and complete independently
            # (engine/serve_lm.py)
            from idunno_tpu_torch.engine.generate import load_lm
            from idunno_tpu_torch.serve.lm_pool import LMServingLoop

            name = p["name"]
            # only the registry check-then-act holds the lock; the heavy
            # build (store fetch + device-state allocation) and the old
            # loop's stop() run outside it, behind a reservation
            # placeholder, so other verbs never stall behind a slow serve
            # validate BEFORE touching the registry: a reload request with
            # a bad option must fail without stopping the live loop
            if p.get("kv_cache_dtype") not in (None, "native", "int8"):
                raise ValueError(
                    f"kv_cache_dtype {p['kv_cache_dtype']!r}: "
                    "want native|int8")
            gw_spec = p.get("gateway")
            if gw_spec:
                # same validate-before-registry rule: a bad gateway spec
                # on a reload must not stop the live loop
                from idunno_tpu_torch.serve.gateway import AdmissionGateway
                gw_spec = AdmissionGateway.validate_spec(gw_spec)
            cp_spec = p.get("cluster_prefix") or None
            if cp_spec is not None:
                # the cluster prefix cache rides the journaled spec like
                # the block-pool keys; it REQUIRES the radix tier
                # (content is addressed per kv block)
                if not int(p.get("kv_block_size", 0)):
                    raise ValueError(
                        "cluster_prefix needs kv_block_size > 0")
                cp_spec = (dict(cp_spec) if isinstance(cp_spec, dict)
                           else {"on": True})
            placeholder = _Starting()
            with self._reg_lock:
                old = self._lm_loops.get(name)
                if old is not None and (isinstance(old, _Starting)
                                        or not p.get("reload")):
                    return {"already": True}
                self._lm_loops[name] = placeholder
                # new loop generation: the old generation's idempotency
                # row ids are dead, drop them
                for k in [k for k in self._lm_idem if k[0] == name]:
                    del self._lm_idem[k]
            try:
                if old is not None:
                    old.stop()
                # group replicas are named "{group}@r{i}" but load the
                # group's stored model, carried as p["model"]
                model = load_lm(node.store, p.get("model") or name,
                                device=node.device)
                if p.get("kv_cache_dtype"):
                    # serve-time override: e.g. int8 KV residency for a
                    # model stored with a native cache (weights unchanged;
                    # the model and each attention layer read it)
                    model.kv_cache_dtype = p["kv_cache_dtype"]
                    for blk in model.blocks:
                        blk.attn.kv_cache_dtype = p["kv_cache_dtype"]
                draft = None
                if p.get("draft"):
                    # speculative decoding: the draft is another
                    # store-persisted LM (typically a much smaller one);
                    # the port's module carries its weights, so the JAX
                    # (model, params) pair becomes (model, None)
                    draft = (load_lm(node.store, p["draft"],
                                     device=node.device), None)
                server = DecodeServer(
                    model,
                    slots=int(p.get("slots", DEFAULT_SLOTS)),
                    prompt_len=int(p["prompt_len"]),
                    max_len=int(p["max_len"]),
                    decode_steps=int(p.get("decode_steps", 1)),
                    quantize=p.get("quantize", "none"),
                    track_logprobs=bool(p.get("track_logprobs", False)),
                    penalties=bool(p.get("penalties", False)),
                    prefix=([int(t) for t in p["prefix"]]
                            if p.get("prefix") else None),
                    eos_id=(int(p["eos_id"])
                            if p.get("eos_id") is not None else None),
                    draft=draft,
                    draft_len=int(p.get("draft_len", 4)),
                    prompt_buckets=(tuple(int(b) for b
                                          in p["prompt_buckets"])
                                    if p.get("prompt_buckets") else None),
                    # paged KV blocks + cross-request radix prefix cache
                    # (0 = off); the keys ride the journaled spec, so a
                    # manager recovery rebuild gets the same pool with an
                    # EMPTY tree — cold misses, never stale KV
                    kv_block_size=int(p.get("kv_block_size", 0)),
                    kv_cache_blocks=int(p.get("kv_cache_blocks", 0)),
                    # block-native paged attention + chunked prefill
                    # (ops/paged_attention.py); both ride the journaled
                    # spec like the block-pool keys above
                    paged_kernel=p.get("paged_kernel"),
                    prefill_chunk=int(p.get("prefill_chunk", 0)),
                    # tensor parallelism over a mesh of the node's local
                    # devices; rides the journaled spec so manager
                    # placement and recovery rebuilds keep the same shape
                    n_model=int(p.get("n_model", 1)),
                    # each all-greedy dispatch one CUDA-graph replay on
                    # a card (decode_graph="auto"), recorded at the
                    # pool's first such dispatch, warmup's included
                    device=node.device)
                if p.get("warmup"):
                    # pay the pool's one-time kernel builds and its graph
                    # capture BEFORE the loop accepts traffic and reset its
                    # accounting, so the first real request's service_s
                    # (the fair-share scheduler's signal,
                    # serve/metrics.py) measures steady-state work
                    server.warmup()
                if cp_spec is not None:
                    # attach AFTER warmup: the throwaway warm request
                    # must not publish its chain to the ring. Replicas
                    # of one group (and re-serves of one pool) derive
                    # the SAME namespace from the same model/weights/
                    # prefix, so their published chains dedupe; an
                    # explicit "namespace" key pins cross-pool sharing
                    # or isolation by hand.
                    from idunno_tpu_torch.serve.cluster_prefix import (
                        ClusterPrefixCache, pool_namespace)
                    ns = cp_spec.get("namespace") or pool_namespace(
                        server.model, server.prefix, server.quantize,
                        server.kv_block_size,
                        extra=str(p.get("model") or ""))
                    server.cluster_prefix = ClusterPrefixCache(
                        node.store, ns, server.kv_block_size,
                        publish_min_hits=int(
                            cp_spec.get("publish_min_hits", 1)))
                gateway = None
                if gw_spec is not None:
                    # QoS front door (serve/gateway.py): per-tenant
                    # quotas + priority/deadline queueing + shedding
                    from idunno_tpu_torch.serve.gateway import AdmissionGateway
                    gateway = AdmissionGateway(gw_spec)
                loop = LMServingLoop(server, name=f"{node.host}-{name}",
                                     gateway=gateway,
                                     spans=getattr(node, "spans", None))
            except BaseException:
                with self._reg_lock:
                    if self._lm_loops.get(name) is placeholder:
                        del self._lm_loops[name]
                raise
            with self._reg_lock:
                if self._lm_loops.get(name) is placeholder:
                    self._lm_loops[name] = loop
                    return {"slots": server.slots}
            loop.stop()               # lm_stop won the race mid-build
            return {"stopped": True}
        if verb == "lm_submit":
            from idunno_tpu_torch.serve.admission import AdmissionShed

            # trace context (utils/spans.py): adopt the submitter's stamp
            # (manager forward, traced client) or mint a root here, so
            # every lm_submit is traceable end to end
            spans = getattr(node, "spans", None)
            tctx = trace_from_payload(p)
            key = p.get("idem")
            if key is not None:
                with self._reg_lock:
                    prior = self._lm_idem.get((p["name"], key))
                if prior is not None:
                    if spans is not None and tctx is not None:
                        # dedup made visible in the waterfall: the retried
                        # hop records a span, the request decodes once
                        spans.record("lm.submit", trace=tctx[0],
                                     parent=tctx[1],
                                     attrs={"pool": p["name"], "rid": prior,
                                            "duplicate": True})
                    return {"id": prior, "duplicate": True}
            sp = None
            if spans is not None:
                sp = spans.start("lm.submit",
                                 trace=tctx[0] if tctx else None,
                                 parent=tctx[1] if tctx else None,
                                 attrs={"pool": p["name"]})
            try:
                rid = self._lm_loop(p["name"]).submit(
                    [int(t) for t in p["prompt"]], int(p["max_new"]),
                    temperature=float(p.get("temperature", 0.0)),
                    top_p=float(p.get("top_p", 1.0)),
                    top_k=int(p.get("top_k", 0)),
                    presence_penalty=float(p.get("presence_penalty", 0.0)),
                    frequency_penalty=float(
                        p.get("frequency_penalty", 0.0)),
                    stop=([[int(t) for t in q] for q in p["stop"]]
                          if p.get("stop") else None),
                    seed=(int(p["seed"]) if p.get("seed") is not None
                          else None),
                    # QoS surface (serve/gateway.py): no-ops on pools
                    # without a gateway beyond priority validation
                    tenant=str(p.get("tenant", "default")),
                    priority=str(p.get("priority", "interactive")),
                    deadline_ms=(float(p["deadline_ms"])
                                 if p.get("deadline_ms") is not None
                                 else None),
                    readmit=bool(p.get("readmit")),
                    trace=sp.ctx if sp is not None else None)
            except AdmissionShed as e:
                # per-reason shed counters on the C8 tracker (the
                # gateway's own stats stay the pool view)
                node.metrics.record_counter(f"gateway_shed_{e.reason}")
                if sp is not None:
                    spans.finish(sp, shed=e.reason)
                raise
            except Exception:
                if sp is not None:
                    spans.finish(sp, error=True)
                raise
            if sp is not None:
                spans.finish(sp, rid=rid)
            if key is not None:
                with self._reg_lock:
                    if len(self._lm_idem) >= 4096:     # bound the map
                        for k in list(self._lm_idem)[:1024]:
                            del self._lm_idem[k]
                    self._lm_idem[(p["name"], key)] = rid
            return {"id": rid}
        if verb == "lm_poll":
            loop = self._lm_loop(p["name"])
            out = {"completions": [
                {"id": c.id, "tokens": c.tokens, "prompt_len": c.prompt_len,
                 "service_s": round(c.service_s, 6),
                 "cold_start": c.cold_start,
                 "cancelled": c.cancelled,
                 **({"rejected": c.rejected}
                    if c.rejected is not None else {}),
                 **({"logprobs": c.logprobs}
                    if c.logprobs is not None else {})}
                for c in loop.poll()]}
            errs = loop.errors()
            if errs:
                out["errors"] = errs
            return out
        if verb == "lm_cancel":
            # best-effort: True = the cancel was initiated (queued request
            # dropped, or live row retiring with its partial tokens);
            # False = unknown id (already completed or never submitted)
            return {"cancelled":
                    self._lm_loop(p["name"]).cancel(int(p["id"]))}
        if verb == "lm_partial":
            # streaming surface: progress of every live row WITHOUT
            # draining completions (lm_poll keeps that role)
            loop = self._lm_loop(p["name"])
            out = {"partial": loop.snapshot()}
            if loop.gateway is not None:
                # recent gateway rejections with reasons, for lm-tail
                out["sheds"] = loop.gateway.recent_sheds()
            return out
        if verb == "lm_qos":
            # QoS observability: gateway queue depths, admit/shed/expire
            # counters and per-class queue-wait percentiles (None when
            # the pool runs without a gateway)
            gw = self._lm_loop(p["name"]).gateway
            return {"qos": gw.stats() if gw is not None else None}
        if verb in ("prefix_publish", "prefix_probe", "prefix_fetch"):
            # cluster prefix cache: publish pushes cached chains to the
            # store's ring, probe reports local-vs-published depth (pure
            # read), fetch (the warm-at-spawn primitive) grafts published
            # chains into the pool's radix tree. All three are fenced and
            # scope-stamped like any pool verb (the _handle preamble) and
            # idempotent by content addressing.
            loop = self._lm_loop(p["name"])
            op = verb.split("_", 1)[1]
            kw: dict = {}
            if p.get("tokens") is not None:
                kw["tokens"] = [int(t) for t in p["tokens"]]
            if op != "probe" and p.get("tenant") is not None:
                kw["tenant"] = str(p["tenant"])
            return loop.prefix_op(op, **kw)
        if verb == "kv_handoff":
            # prefill → decode block handoff: fenced and scope-stamped by
            # the _handle preamble like every pool verb, idempotent by
            # radix-graft reuse
            return self._kv_handoff(p)
        if verb == "lm_stats":
            loop = self._lm_loop(p["name"])
            stats = loop.stats()
            # how the pool's dispatches ran: replayed CUDA graphs or eager
            stats["decode_graph"] = loop.server.graph_stats()
            # surface pool gauges on the node's C8 metrics tracker so the
            # cluster metrics plane (metrics_export) sees them: tensor-
            # parallel shape + per-step psum payload always, plus the
            # prefix-cache gauges and the paged/chunked win counters when
            # the cache is on (gather traffic avoided, admissions split)
            cfg = stats.get("config", {})
            gauges = {"n_model": cfg.get("n_model", 1),
                      "tp_collective_bytes": cfg.get(
                          "tp_collective_bytes", 0),
                      "sampling_collective_bytes": cfg.get(
                          "sampling_collective_bytes", 0)}
            pc = stats.get("prefix_cache")
            if pc is not None:
                gauges.update(
                    pc,
                    kv_gather_bytes_saved=stats.get(
                        "kv_gather_bytes_saved", 0),
                    prefill_chunks=stats.get("prefill_chunks", 0),
                    # DistServe handoff gauges: ships from /
                    # KVC1 bytes through / ships abandoned on this pool
                    kv_handoff_requests=stats.get(
                        "kv_handoff_requests", 0),
                    kv_handoff_bytes=stats.get("kv_handoff_bytes", 0),
                    kv_handoff_fallbacks=stats.get(
                        "kv_handoff_fallbacks", 0))
            node.metrics.record_lm_gauges(p["name"], gauges)
            # the node's differential-health verdict summary (worst peer deviation ratio, quarantine count) and the
            # process-wide hedge counters ride every lm_stats reply so
            # `lm-stats` shows the gray-failure picture without a
            # separate scrape
            from idunno_tpu_torch.comm.retry import retry_counters as _rc
            hl = getattr(node.membership, "health", None)
            if hl is not None:
                c = _rc()
                stats["node_health"] = dict(
                    hl.gauges(),
                    hedged_rpcs=c["hedged_rpcs"],
                    hedge_wins=c["hedge_wins"])
            gw = stats.get("gateway")
            if gw is not None:
                node.metrics.record_gateway_gauges(p["name"], {
                    "queued": gw["queued"],
                    **{f"{c}_{k}": cls[k]
                       for c, cls in gw["classes"].items()
                       for k in ("queued", "admitted", "dispatched",
                                 "expired", "reject_rate")},
                    **{f"{c}_wait_{q}": cls["queue_wait_s"][q]
                       for c, cls in gw["classes"].items()
                       for q in ("p50", "p95", "p99")}})
            return {"stats": stats}
        if verb == "lm_stop":
            with self._reg_lock:
                loop = self._lm_loops.pop(p["name"], None)
                for k in [k for k in self._lm_idem
                          if k[0] == p["name"]]:
                    del self._lm_idem[k]
            if loop is not None and not isinstance(loop, _Starting):
                loop.stop()
            # popping a _Starting reservation makes the building call's final
            # registry compare fail, so it stops its fresh loop itself
            return {"stopped": loop is not None}
        if verb == "train_start":
            # cluster training job: corpus from the replicated store,
            # periodic train-state checkpoints back into it, final servable
            # LM published for lm_serve/generate (engine/train_job.py), on
            # the node's device
            from idunno_tpu_torch.engine.train_job import LMTrainJob

            name = p["name"]
            with self._reg_lock:
                existing = self._train_jobs.get(name)
                if existing is not None:
                    st = existing.status()
                    if not (st["done"] or st["stopped"] or st["error"]):
                        raise ValueError(f"training job {name!r} already "
                                         "running (train_stop it first)")
                self._train_jobs[name] = LMTrainJob(
                    node.store, name,
                    corpus=p["corpus"],
                    model_config=dict(p["model"]),
                    steps=int(p["steps"]),
                    batch_size=int(p.get("batch_size", 8)),
                    seq_len=int(p.get("seq_len", 32)),
                    lr=float(p.get("lr", 1e-2)),
                    checkpoint_every=int(p.get("checkpoint_every", 50)),
                    seed=int(p.get("seed", 0)),
                    resume=bool(p.get("resume", False)),
                    device=node.device)
            return {"started": True}
        if verb == "profile":
            # capture a torch.profiler trace of whatever this node executes
            # during the window (worker jobs, decode pools: their threads'
            # operators and the card's kernels) — remote, on-demand
            # observability the reference never had (its only timing is
            # host wall-clock prints, `alexnet_resnet.py:91-92`)
            import time as _time

            from idunno_tpu_torch.utils.tracing import trace

            seconds = float(p.get("seconds", 3.0))
            if not 0.0 < seconds <= 60.0:
                raise ValueError(f"seconds={seconds}: want (0, 60]")
            log_dir = p.get("log_dir") or os.path.join(
                node.store.local.data_dir, "profiles",
                _time.strftime("%Y%m%d-%H%M%S"))
            with trace(log_dir):
                _time.sleep(seconds)
            return {"log_dir": log_dir, "seconds": seconds}
        if verb == "train_status":
            with self._reg_lock:
                job = self._train_jobs.get(p["name"])
            if job is None:
                raise ValueError(f"no training job {p['name']!r}")
            return job.status()
        if verb == "train_stop":
            with self._reg_lock:
                job = self._train_jobs.get(p["name"])
            if job is None:
                return {"stopped": False}
            job.stop()
            # "stopped" = the stop verb found+stopped a job; the job's own
            # lifecycle flags live under "status" (its 'stopped' field is
            # False when the job had already finished)
            return {"stopped": True, "status": job.status()}
        if verb == "spans_dump":
            # node-local span window (utils/spans.py); the cluster-wide
            # view is the `trace` verb below
            spans = getattr(node, "spans", None)
            return {"node": node.host,
                    "spans": ([] if spans is None else spans.dump(
                        trace_id=p.get("trace_id"),
                        limit=(int(p["limit"])
                               if p.get("limit") else None)))}
        if verb == "trace":
            return self._collect_trace(p)
        if verb == "metrics_export":
            # Prometheus text exposition of everything observable on this
            # node: C8 tracker counters/rates/percentiles/gauges plus the
            # process-wide retry counters and span-buffer gauges
            from idunno_tpu_torch.comm.retry import retry_counters

            target = p.get("host")
            if target and target != node.host:
                out = node.transport.call(
                    target, SERVICE,
                    Message(MessageType.INFERENCE, node.host,
                            {"verb": "metrics_export"}), timeout=5.0)
                if out is None or out.type is not MessageType.ACK:
                    raise ValueError(f"metrics_export: {target} unreachable")
                return {"text": out.payload["text"]}
            spans = getattr(node, "spans", None)
            extra_g = {}
            if spans is not None:
                extra_g["span_buffer_depth"] = spans.depth()
                extra_g["spans_recorded_total"] = spans.recorded_total()
            fo = getattr(node, "failover", None)
            if fo is not None:
                # the durability-gap counter (acked work whose write-ahead was skipped because the
                # standby was down) joins the scrape; the per-pool
                # adoption/replay counters ride the tracker's
                # record_counter events automatically
                extra_g["wal_skips"] = fo.wal_skips
                # cumulative bytes shipped over the
                # per-pool WAL (delta frames + full fallbacks) — the
                # number the delta compaction is supposed to shrink
                extra_g["pool_wal_bytes"] = fo.pool_wal_bytes()
            lmgr = getattr(node, "lm_manager", None)
            if lmgr is not None:
                # journal rows compacted out of
                # shipped per-pool WAL segments below the delivered
                # low-water mark
                extra_g["pool_wal_truncated"] = lmgr.wal_truncated
            # ownership-routing counters are always present in
            # the scrape (zero until the first redirect/handoff) so
            # dashboards can alert on them without a priming event
            # node_health_score (worst peer deviation ratio)
            # and quarantined_nodes from the differential ledger; the
            # hedge counters ride retry_counters() below
            hl = getattr(node.membership, "health", None)
            if hl is not None:
                extra_g.update(hl.gauges())
            extra_c = dict(retry_counters())
            cc = node.metrics.counters()
            # handoff-fallback, predictive-spawn and
            # gray-failure routing counters join the always-present set
            # (zero until the first event)
            for k in ("scope_owner_redirects", "scope_owner_moves",
                      "kv_handoff_fallbacks", "predictive_spawns",
                      "early_redispatches", "quarantine_reroutes"):
                extra_c.setdefault(k, cc.get(k, 0))
            return {"text": node.metrics.prometheus_text(
                node.host, extra_counters=extra_c,
                extra_gauges=extra_g)}
        if verb == "lm_autoscale":
            # only meaningful for a manager-owned replica group (routed
            # above); reaching here means the name isn't one
            raise ValueError(
                f"no replica group {p.get('name')!r}; lm_serve with "
                "autoscale={...} (placement=auto) creates one")
        raise ValueError(f"unknown control verb {verb!r}")

    def _collect_trace(self, p: dict) -> dict:
        """Cluster-wide trace collection: resolve the trace id (given
        directly, or looked up from an LM pool request id / CNN qnum),
        then fan `spans_dump` out to every alive member and merge the
        returned spans sorted by start time — the shell waterfall and
        `tools/trace_export.py` both consume this."""
        node = self.node
        tid = p.get("trace_id")
        if tid is None and p.get("name") is not None \
                and p.get("id") is not None:
            name, rid = p["name"], int(p["id"])
            mgr = getattr(node, "lm_manager", None)
            if mgr is not None and mgr.has_pool(name) \
                    and not p.get("local"):
                tid = mgr.trace_of(name, rid)
            else:
                with self._reg_lock:
                    loop = self._lm_loops.get(name)
                if loop is not None and not isinstance(loop, _Starting):
                    tid = loop.trace_of(rid)
        if tid is None and p.get("model") is not None \
                and p.get("qnum") is not None:
            tid = node.inference.trace_of(p["model"], int(p["qnum"]))
        if tid is None:
            raise ValueError(
                "trace: pass trace_id, or name+id for an LM request, or "
                "model+qnum for a CNN query (unknown/untraced ids "
                "resolve to nothing)")
        merged: list[dict] = []
        nodes: list[str] = []
        ask = {"verb": "spans_dump", "trace_id": tid, "local": True}
        for h in node.membership.members.alive_hosts():
            if h == node.host:
                spans = getattr(node, "spans", None)
                got = [] if spans is None else spans.dump(trace_id=tid)
            else:
                try:
                    out = node.transport.call(
                        h, SERVICE, Message(MessageType.INFERENCE,
                                            node.host, dict(ask)),
                        timeout=5.0)
                except Exception:  # noqa: BLE001 - best-effort collection
                    continue
                if out is None or out.type is not MessageType.ACK:
                    continue
                got = out.payload.get("spans", [])
            if got:
                nodes.append(h)
                merged.extend(got)
        merged.sort(key=lambda s: (s.get("t_start", 0.0), s["span_id"]))
        return {"trace_id": tid, "spans": merged, "nodes": nodes}

    def _kv_handoff(self, p: dict) -> dict:
        """DistServe KV-block handoff. Node-local ops ("probe"
        | "export" | "adopt" | "fallback") marshal onto the named pool's
        loop thread; op="ship" ORCHESTRATES from the prefill pool's node:
        probe the decode target for its already-held depth, export only
        the missing block suffix as KVC1 blobs (`store/kv_chain.py`
        codec), and push them point-to-point to the target's adopt — no
        SDFS round-trip on the critical path. KVC1 blobs ride the RPC
        payload as latin-1 strings (the `put_bytes` idiom). Any failure
        after the ship starts bumps the fallback counter on THIS pool and
        re-raises: the caller (lm_manager._handoff_ship) falls back to
        decode-side prefill — a handoff is only ever an optimization,
        never a correctness dependency. Idempotent end to end: export
        reads cached blocks, adopt grafts with reuse-on-existing
        semantics, so a replayed ship converges on the same tree."""
        node = self.node
        op = p.get("op", "")
        loop = self._lm_loop(p["name"])
        toks = ([int(t) for t in p["tokens"]]
                if p.get("tokens") is not None else None)
        spans = getattr(node, "spans", None)
        tctx = trace_from_payload(p)
        tr = tctx if spans is not None else None
        if op == "probe":
            return loop.handoff_op("probe", tokens=toks)
        if op == "export":
            out = loop.handoff_op("export", tokens=toks,
                                  from_depth=int(p.get("from_depth", 0)),
                                  trace=tr)
            out["blobs"] = [b.decode("latin-1") for b in out["blobs"]]
            return out
        if op == "adopt":
            return loop.handoff_op(
                "adopt", tokens=toks,
                blobs=[b.encode("latin-1") for b in p["blobs"]],
                start_depth=int(p.get("start_depth", 0)), trace=tr)
        if op == "fallback":
            return loop.handoff_op("fallback")
        if op != "ship":
            raise ValueError(f"unknown kv_handoff op {op!r}")
        target_host = p["target_host"]
        target_name = p.get("target_name") or p["name"]
        if target_host == node.host and target_name == p["name"]:
            raise ValueError("kv_handoff ship: target is the source pool")
        sp = None
        if spans is not None:
            sp = spans.start("lm.handoff",
                             trace=tctx[0] if tctx else None,
                             parent=tctx[1] if tctx else None,
                             attrs={"pool": p["name"],
                                    "target": target_host,
                                    "target_pool": target_name})
        ctx = sp.ctx if sp is not None else None

        def _call(payload: dict) -> dict:
            # child hops chain under the ship span and carry this node's
            # fence view (the stamp checker's send-site rule)
            stamp_trace(payload, ctx)
            payload["epoch"] = list(node.membership.epoch.view())
            out = node.transport.call(
                target_host, SERVICE,
                Message(MessageType.INFERENCE, node.host, payload),
                timeout=float(p.get("timeout", 30.0)))
            if out is None:
                raise TransportError(
                    f"kv_handoff: {target_host} gave no reply",
                    reason="timeout")
            observe_payload(node.membership.epoch, out.payload)
            if out.type is not MessageType.ACK:
                raise ValueError(str(
                    (out.payload or {}).get("error", "kv_handoff failed")))
            return dict(out.payload or {})

        try:
            probe = _call({"verb": "kv_handoff", "op": "probe",
                           "name": target_name, "tokens": list(toks),
                           "local": True})
            depth = int(probe["depth"])
            export = loop.handoff_op("export", tokens=toks,
                                     from_depth=depth, trace=ctx)
            if export["blocks"] == 0:
                # the target already holds every shippable block — the
                # delta is empty, decode admits with a pure local hit
                if sp is not None:
                    spans.finish(sp, blocks=0, bytes=0, held_depth=depth)
                return {"shipped": 0, "bytes": 0, "depth": depth,
                        "already": True}
            adopt = _call({
                "verb": "kv_handoff", "op": "adopt", "name": target_name,
                "tokens": list(toks),
                "blobs": [b.decode("latin-1") for b in export["blobs"]],
                "start_depth": depth, "local": True})
        except Exception:
            # count the abandoned ship on the PREFILL pool (its blocks
            # were exported for nothing) and on the node tracker for
            # metrics_export; the request itself survives via the
            # caller's decode-side-prefill fallback
            try:
                loop.handoff_op("fallback")
            except Exception:  # noqa: BLE001 - counter must not mask
                pass
            node.metrics.record_counter("kv_handoff_fallbacks")
            if sp is not None:
                spans.finish(sp, error=True)
            raise
        if sp is not None:
            spans.finish(sp, blocks=export["blocks"],
                         bytes=export["bytes"],
                         adopted_depth=adopt.get("depth"))
        return {"shipped": export["blocks"], "bytes": export["bytes"],
                "depth": depth, "adopted": adopt.get("adopted", 0),
                "target_depth": adopt.get("depth")}

    # pool-directed verbs that route by scope owner
    _POOL_VERBS = ("lm_submit", "lm_poll", "lm_stats", "lm_stop",
                   "lm_cancel", "lm_partial", "lm_qos", "lm_autoscale",
                   "prefix_publish", "prefix_probe", "prefix_fetch",
                   "kv_handoff")

    def _forward_scope_owner(self, p: dict, name: str, owner: str) -> dict:
        """Owner-aware routing: this node does not hold the
        pool but the gossiped ownership map names an alive owner —
        forward the verb there transparently (ONE hop: the forwarded
        payload carries ``_owner_hop`` so a stale map can never loop)
        and relay the owner's reply. The hop is the counted redirect;
        clients that pre-route by their own owner view skip it."""
        node = self.node
        node.metrics.record_counter("scope_owner_redirects")
        fwd = dict(p, _owner_hop=True,
                   epoch=list(node.membership.epoch.view()))
        try:
            out = node.transport.call(
                owner, SERVICE,
                Message(MessageType.INFERENCE, node.host, fwd),
                timeout=30.0)
        except TransportError as e:
            raise ValueError(f"scope owner {owner} for {name!r} "
                             f"unreachable: {e}") from e
        if out is None:
            raise ValueError(
                f"scope owner {owner} for {name!r} gave no reply")
        observe_payload(node.membership.epoch, out.payload)
        if out.type is MessageType.ERROR:
            # relay the owner's typed error verbatim — flattening it to a
            # string here would strip the stale_epoch/scope/scope_owner
            # markers a chained redirect needs
            raise RelayedError(dict(out.payload or {}))
        return dict(out.payload or {})

    def _route_cluster(self, verb: str, p: dict) -> dict | None:
        """Cluster-managed LM tier (serve/lm_manager.py): placement verbs
        carry ``placement="auto"`` and MUST land on the acting master
        (which hands each scope to its rendezvous owner); follow-up verbs
        route by SCOPE OWNER — the holder serves them, any other node
        forwards one hop to the gossiped owner, and a deposed holder
        answers with a typed ``ScopeOwnerRedirect``. ``local=True`` (set
        by the manager's own node-to-node RPCs) pins the node-local tier,
        so a managed pool's host still answers the manager. None = not a
        cluster-routed call, fall through."""
        mgr = getattr(self.node, "lm_manager", None)
        if mgr is None or p.get("local"):
            return None
        if verb == "lm_serve" and p.get("placement") == "assign":
            # owner landing of a scope assign hop (pool_assign contract):
            # the acting master placed this scope here — serve it now, no
            # re-forward (assign is a single hop); a replayed assign finds
            # the named pool and absorbs as already=True
            return mgr.serve(p, assigned=True)
        placed = (p.get("placement") == "auto"
                  and verb in ("lm_serve", "train_start"))
        if placed:
            master = self.node.membership.acting_master()
            if master != self.node.host \
                    or not self.node.membership.is_acting_master:
                raise ValueError(
                    f"placement=auto must go to the acting master "
                    f"({master}), not {self.node.host}")
            return (mgr.serve(p) if verb == "lm_serve"
                    else mgr.train(p))
        name = p.get("name")
        if verb in self._POOL_VERBS and not mgr.has_pool(name):
            # not held here: forward one hop to the scope's claimed owner.
            # The claim is trusted even when our liveness view lags (a
            # healed node may observe the claim a wave before the owner's
            # RUNNING refutation) — a genuinely dead owner surfaces as
            # the typed unreachable error, and its successor's fresher
            # claim arrives on the same gossip that revives liveness.
            owners = getattr(self.node.membership, "owners", None)
            if owners is not None and not p.get("_owner_hop"):
                scope = pool_scope(name)
                owner = owners.owner(scope)
                if owner == self.node.host:
                    # our own stale claim (we just stepped this scope
                    # down): guess the successor by rendezvous placement
                    # over the alive view rather than bouncing the client
                    alive = set(
                        self.node.membership.members.alive_hosts())
                    # quarantine-blind: the guess must match the adoption
                    # formula (failover._adopt_scopes_of) — see the
                    # split-brain note there
                    owner = place_scope(
                        scope, self.node.config.hosts, alive)
                if owner is not None and owner != self.node.host:
                    return self._forward_scope_owner(p, name, owner)
            # UNCLAIMED scope (direct pools, bare harnesses, or the
            # pre-gossip window): fall through to the node-local tier —
            # its "no lm_serve pool" error is the pre-ownership behavior
        if verb in self._POOL_VERBS and mgr.has_pool(name):
            owners = getattr(self.node.membership, "owners", None)
            claimed = (owners.owner(pool_scope(name))
                       if owners is not None else None)
            if owners is None or claimed is None:
                # no ownership map (bare harnesses) or an unclaimed
                # scope: the single-master rule — only the acting master may
                # serve a managed journal
                if not self.node.membership.is_acting_master:
                    raise ValueError(
                        f"{self.node.host} is not the acting master; its "
                        f"managed journal for {name!r} is fenced")
            elif claimed != self.node.host:
                # deposed holder: the scope's adopter out-claimed us —
                # step down for this scope only and redirect, typed;
                # serving the stale journal would double-deliver
                mgr.step_down_scope(pool_scope(name))
                raise ScopeOwnerRedirect(pool_scope(name), claimed)
            if verb == "lm_submit":
                rid = mgr.submit(name, [int(t) for t in p["prompt"]],
                                 int(p["max_new"]),
                                 top_p=float(p.get("top_p", 1.0)),
                                 top_k=int(p.get("top_k", 0)),
                                 presence_penalty=float(
                                     p.get("presence_penalty", 0.0)),
                                 frequency_penalty=float(
                                     p.get("frequency_penalty", 0.0)),
                                 stop=([[int(t) for t in q]
                                        for q in p["stop"]]
                                       if p.get("stop") else None),
                                 temperature=float(
                                     p.get("temperature", 0.0)),
                                 seed=(int(p["seed"])
                                       if p.get("seed") is not None
                                       else None),
                                 tenant=str(p.get("tenant", "default")),
                                 priority=str(p.get("priority",
                                                    "interactive")),
                                 deadline_ms=(float(p["deadline_ms"])
                                              if p.get("deadline_ms")
                                              is not None else None),
                                 idem_key=p.get("idem"),
                                 trace=trace_from_payload(p))
                return {"id": rid}
            if verb == "lm_poll":
                return mgr.poll(name)
            if verb == "lm_stats":
                return {"stats": mgr.stats(name)}
            if verb == "lm_cancel":
                return mgr.cancel(name, int(p["id"]))
            if verb == "lm_partial":
                return mgr.partial(name)
            if verb == "lm_qos":
                out = mgr.qos(name)
                grp = out.get("group")
                if grp is not None:
                    # autoscaler observability rides the metrics tracker
                    # (Prometheus metrics_export + chaos snapshots)
                    states = [m.get("state") for m
                              in grp.get("replicas", {}).values()]
                    fc = grp.get("forecast") or {}
                    self.node.metrics.record_autoscale_gauges(name, {
                        "replicas": len(states),
                        "draining": states.count("draining"),
                        "decisions_total": grp.get("decisions_total", 0),
                        # predictive scale-ahead view
                        "predicted_rate": fc.get("predicted_rate", 0.0),
                        "predictive_spawns": fc.get(
                            "predictive_spawns", 0)})
                return out
            if verb == "lm_autoscale":
                # policy get/set for a replica group (serve/autoscaler.py)
                if p.get("policy"):
                    return mgr.autoscale_set(name, dict(p["policy"]))
                return mgr.autoscale_get(name)
            if verb in ("prefix_publish", "prefix_probe",
                        "prefix_fetch"):
                # managed pools: relay to the pool's node (or fan over a
                # group's replicas) — prefix state lives on the serving
                # node, the journal only knows the spec
                return mgr.prefix_op(verb, name, p)
            if verb == "kv_handoff":
                # managed pools: relay to the pool's serving node — a
                # ship must orchestrate FROM the prefill replica's own
                # host (its loop owns the exported blocks)
                return mgr.kv_handoff(name, p)
            return mgr.stop(name)
        if verb in ("train_status", "train_stop") and mgr.has_job(name):
            return (mgr.train_status(name) if verb == "train_status"
                    else mgr.train_stop(name))
        return None

    def _lm_loop(self, name: str):
        with self._reg_lock:
            loop = self._lm_loops.get(name)
        if loop is None:
            raise ValueError(f"no lm_serve pool for {name!r}; "
                             "call lm_serve first")
        if isinstance(loop, _Starting):
            raise ValueError(f"lm_serve pool for {name!r} is still "
                             "starting; retry shortly")
        return loop
