"""The port's entry point, ``python -m idunno_tpu_torch``, as real OS
processes on real sockets — the port of the JAX package's
``tests/test_multiprocess_e2e.py`` cluster boot and its LM pool over real
sockets, on the CPU (``--cpu``):

- two node processes join over TCP/UDP; this process drives them through
  the control RPC (``comm.net.oneshot_call``): an ``inference`` query over
  images 0-49 returns 50 records, a store-persisted LM (the port's blob of
  JAX weights, ``put`` from a file) answers ``generate`` and a paged
  ``lm_serve`` pool with the greedy tokens of JAX ``generate`` — JSON round
  trips of prompts, seeds and replies included, which the in-process
  tests cannot see;
- without ``--cpu``, on a machine with no card, the command exits non-zero
  and names the missing card.

Every node process is stopped in a ``finally``.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idunno_tpu.engine.generate import generate as jax_generate
from idunno_tpu.models.transformer import TransformerLM as JaxLM
from idunno_tpu_torch.comm.message import Message
from idunno_tpu_torch.comm.net import oneshot_call
from idunno_tpu_torch.comm.transport import TransportError
from idunno_tpu_torch.engine.generate import lm_store_name, save_lm
from idunno_tpu_torch.models.convert import lm_state_dict_from_flax
from idunno_tpu_torch.models.transformer import TransformerLM
from idunno_tpu_torch.utils.types import MessageType
from tests.torch_workers import share_cores  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 48


def _free_port_base(n: int, spread: int = 100) -> int:
    """A port base such that base..base+spread*n is plausibly free
    (bind-probe the ports the nodes will take)."""
    for base in range(23000 + (os.getpid() * 7) % 2000, 64000, 777):
        try:
            for i in range(n):
                for off in (0, 5):
                    with socket.socket() as s:
                        s.bind(("127.0.0.1", base + off + spread * i))
        except OSError:
            continue
        return base
    raise RuntimeError("no free port range")


def _control(port: int, verb: str, timeout: float = 30.0, **kw) -> dict:
    out = oneshot_call("127.0.0.1", port, "control",
                       Message(MessageType.INFERENCE, "client",
                               {"verb": verb, **kw}), timeout=timeout)
    assert out is not None, f"no reply to {verb}"
    assert out.type is MessageType.ACK, out.payload
    return out.payload


def _write_config(tmp_path, hosts) -> tuple:
    base = _free_port_base(len(hosts))
    cfg = {
        "hosts": hosts, "coordinator": hosts[0],
        "standby_coordinator": hosts[-1], "introducer": hosts[0],
        "ports": {"membership": base, "store": base + 5,
                  "inference": base + 10, "result": base + 15,
                  "metadata": base + 20, "grep": base + 25},
        "ping_interval_s": 0.2, "failure_timeout_s": 4.0,
        "replication_factor": len(hosts), "query_batch_size": 64,
        "query_interval_s": 0.0, "metadata_interval_s": 0.5,
        "engine": {"batch_size": 8, "image_size": 64, "resize_size": 64,
                   "compute_dtype": "float32"},
    }
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps(cfg))
    # control RPC goes to each node's single TCP listener (the store port)
    return path, {h: base + 5 + 100 * i for i, h in enumerate(hosts)}


@contextlib.contextmanager
def _boot_cluster(tmp_path, hosts):
    """One ``python -m idunno_tpu_torch --cpu --no-shell`` process per
    host, membership converged; yields the control port of each host."""
    cfg_path, tcp = _write_config(tmp_path, hosts)
    procs: dict[str, subprocess.Popen] = {}
    try:
        for h in hosts:
            with open(tmp_path / f"{h}.err", "wb") as err:
                procs[h] = subprocess.Popen(
                    [sys.executable, "-m", "idunno_tpu_torch", "--host", h,
                     "--config", str(cfg_path), "--cpu", "--no-shell",
                     "--data-dir", str(tmp_path / h)],
                    cwd=REPO, stdout=subprocess.DEVNULL, stderr=err)
        deadline = time.time() + 90
        while True:
            try:
                st = _control(tcp[hosts[0]], "status", timeout=5.0)
                if (sorted(st["members"]) == sorted(hosts) and
                        all(v == "RUNNING" for v in st["members"].values())):
                    break
            except (AssertionError, OSError, TransportError):
                pass            # boot window: listener not serving yet
            dead = {h: p.returncode for h, p in procs.items()
                    if p.poll() is not None}
            assert not dead, (dead, (tmp_path / f"{hosts[0]}.err")
                              .read_text()[-2000:])
            assert time.time() < deadline, "cluster never converged"
            time.sleep(0.3)
        yield tcp
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def test_two_node_processes_serve_cnn_and_lm(tmp_path):
    jm = JaxLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(9),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    tm = TransformerLM(vocab=VOCAB, dim=32, depth=2, num_heads=4)
    tm.load_state_dict(lm_state_dict_from_flax(jax.tree.map(np.asarray,
                                                            params)))

    class _FileStore:
        def put_bytes(self, name, blob):
            (tmp_path / "lm.blob").write_bytes(blob)
            return 1

    save_lm(_FileStore(), "chat", tm)

    with _boot_cluster(tmp_path, ["n0", "n1"]) as tcp:
        st = _control(tcp["n1"], "status")
        assert st["acting_master"] == "n0"

        q = _control(tcp["n0"], "inference", model="resnet", start=0, end=49)
        records = []
        for qnum in q["qnums"]:
            deadline = time.time() + 120
            while not _control(tcp["n0"], "query_done", model="resnet",
                               qnum=qnum)["done"]:
                assert time.time() < deadline, "query never finished"
                time.sleep(0.2)
            records += _control(tcp["n0"], "results", model="resnet",
                                qnum=qnum)["records"]
        assert sorted(r[0] for r in records) == sorted(
            f"test_{i}.JPEG" for i in range(50))
        assert all(isinstance(c, str) and 0.0 <= p <= 1.0
                   for _, c, p in records)

        # the LM blob reaches the store from a file (shared fs: the node
        # reads the file this test wrote)
        put = _control(tcp["n1"], "put", local=str(tmp_path / "lm.blob"),
                       name=lm_store_name("chat"))
        assert put["version"] == 1

        prompt = [7, 3, 11]
        want = np.asarray(jax_generate(
            jm, params, jnp.asarray([prompt], jnp.int32), prompt_len=3,
            max_new=6))[0].tolist()
        out = _control(tcp["n1"], "generate", name="chat", prompt=[prompt],
                       max_new=6, timeout=60.0)
        assert out["tokens"] == [want]

        out = _control(tcp["n0"], "lm_serve", name="chat", slots=2,
                       prompt_len=4, max_len=16, kv_block_size=2,
                       paged_kernel="auto", timeout=120.0)
        assert out.get("slots") == 2
        greedy = _control(tcp["n0"], "lm_submit", name="chat",
                          prompt=prompt, max_new=6)["id"]
        sampled = _control(tcp["n0"], "lm_submit", name="chat",
                           prompt=prompt, max_new=6, temperature=0.9,
                           top_p=0.8, seed=123)["id"]
        done = {}
        deadline = time.time() + 60
        while time.time() < deadline and len(done) < 2:
            reply = _control(tcp["n0"], "lm_poll", name="chat")
            assert not reply.get("errors"), reply["errors"]
            for c in reply["completions"]:
                done[c["id"]] = c
            time.sleep(0.1)
        assert set(done) == {greedy, sampled}, done
        assert done[greedy]["tokens"] == want
        assert done[greedy]["service_s"] > 0          # wire field intact
        assert len(done[sampled]["tokens"]) == 3 + 6
        assert all(0 <= t < VOCAB for t in done[sampled]["tokens"])
        st = _control(tcp["n0"], "lm_stats", name="chat")["stats"]
        assert st["completed"] == 2 and st["config"]["device"] == "cpu"
        assert _control(tcp["n0"], "lm_stop", name="chat")["stopped"]


def test_config_engine_block_takes_the_ports_values(tmp_path):
    """The config's ``engine`` block builds the port's EngineConfig; a
    value of the JAX package's (``"pallas"``) raises, naming the port's."""
    from idunno_tpu_torch.__main__ import load_config

    path, _ = _write_config(tmp_path, ["n0", "n1"])
    config, addresses, engine = load_config(str(path))
    assert config.hosts == ("n0", "n1") and addresses == {}
    assert (engine.batch_size, engine.preprocess) == (8, "auto")
    raw = json.loads(path.read_text())
    raw["engine"]["preprocess"] = "pallas"
    path.write_text(json.dumps(raw))
    with pytest.raises(ValueError, match="auto\\|fold\\|kernel\\|plain"):
        load_config(str(path))


def test_entry_point_without_card_exits_nonzero(tmp_path):
    """No ``--cpu`` and no card: the node does not start on the CPU."""
    cfg_path, _ = _write_config(tmp_path, ["n0"])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "idunno_tpu_torch", "--host", "n0",
         "--config", str(cfg_path), "--no-shell",
         "--data-dir", str(tmp_path / "n0")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0
    assert "no CUDA device" in err, err
