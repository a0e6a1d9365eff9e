"""Static guards of the port's two import rules, by ``ast`` (a runtime
check cannot tell: an interpreter may import JAX at start-up on its own):

- nothing under ``idunno_tpu_torch/``, and not ``chip_smoke.py``, imports
  ``jax``, ``flax``, ``optax`` or anything of ``idunno_tpu``: one case per
  file;
- a module the port declares a copy of a JAX package module has the JAX
  module's code: the same syntax tree once ``idunno_tpu`` is read as
  ``idunno_tpu_torch`` in its imports, docstrings aside, and the same text
  outside comments and docstrings. The port's copies drop the JAX modules'
  citations of tracker numbers from their comments and docstrings, so
  those may differ;
- the protocol analyzer's modules (``RETARGETED_COPIES``) have the JAX
  modules' code once a string naming the JAX package's tree reads as the
  port's, their registries aside, which keep every JAX row;
- a module the port copies in part (``PARTIAL_COPIES``) has the JAX
  module's code, docstrings aside, in each of the named top-level
  functions and assignments;
- the port's bench keeps the repository ``bench.py``'s FLOP counters byte
  for byte, and ``utils/loadgen.py`` the load tools' definitions it
  copies (``LOADGEN_COPIES``).
"""
import ast
import difflib
import io
import os
import tokenize

import pytest
from tests.torch_workers import share_cores  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "idunno_tpu_torch")
BANNED = ("jax", "flax", "optax", "idunno_tpu",
          # the JAX package's entry points and tools at the root
          "tools", "bench", "__graft_entry__")

PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(PORT) for f in files if f.endswith(".py")
) + ["chip_smoke.py"]

# modules of the port that are copies of the JAX package's (path under
# each package); native/__init__.py is not one: it builds its library
# into idunno_tpu_torch/build/ instead of beside its sources
COPIES = [
    "cli/__init__.py", "cli/shell.py",
    "comm/__init__.py", "comm/inproc.py", "comm/message.py", "comm/net.py",
    "comm/retry.py", "comm/transport.py",
    "engine/__init__.py", "engine/data_store.py",
    "grep/__init__.py", "grep/loggrep.py",
    "membership/__init__.py", "membership/epoch.py", "membership/health.py",
    "membership/list.py", "membership/service.py",
    "models/classes.py",
    "scheduler/__init__.py", "scheduler/fair.py", "scheduler/tasks.py",
    "serve/__init__.py", "serve/admission.py", "serve/autoscaler.py",
    "serve/failover.py", "serve/gateway.py", "serve/inference_service.py",
    "serve/lm_manager.py", "serve/lm_pool.py", "serve/metrics.py",
    "serve/prefix_cache.py",
    "store/__init__.py", "store/sdfs.py",
    "utils/__init__.py", "utils/logging.py", "utils/ring.py",
    "utils/spans.py", "utils/types.py",
    "chaos.py",
]

# the protocol analyzer's modules: copies of the JAX package's retargeted to
# the port's tree, so a string that names the JAX package's tree
# (``"idunno_tpu"``, ``"idunno_tpu/..."``) reads as the port's; the named
# top-level registries are left out of the comparison here and held by
# test_analyzer_registries_keep_the_jax_rows instead
RETARGETED_COPIES = {
    "analysis/__init__.py": [], "analysis/allowlist.py": [],
    "analysis/contracts.py": ["IDEM_VERBS", "GUARDED"],
    "analysis/core.py": [], "analysis/determinism.py": [],
    "analysis/errorlint.py": ["BASELINE_TARGETS"],
    "analysis/fence_check.py": [], "analysis/idem_check.py": [],
    "analysis/lock_discipline.py": [], "analysis/retry_safety.py": [],
    "analysis/stamp_check.py": [],
}


# modules of the port that keep some of a JAX module's definitions as they
# are (path under each package → top-level names): the KVC1 codec keeps
# the JAX names, hashes and constants; its encode and decode take and give
# torch tensors
PARTIAL_COPIES = {
    "store/kv_chain.py": ["MAGIC", "BLOB_PREFIX", "TENANT_PREFIX",
                          "namespace_key", "rolling_hashes", "chain_names",
                          "tenant_index_name"],
}


def imported_modules(tree: ast.AST) -> list[str]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in imported_modules(tree)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", ["idunno_tpu_torch/models/moe.py",
                                  "idunno_tpu_torch/models/mixed.py",
                                  "idunno_tpu_torch/parallel/__init__.py",
                                  "idunno_tpu_torch/parallel/expert.py",
                                  "idunno_tpu_torch/parallel/mesh.py",
                                  "idunno_tpu_torch/parallel/sharding.py",
                                  "idunno_tpu_torch/parallel/ring_attention.py",
                                  "idunno_tpu_torch/parallel/ulysses.py",
                                  "idunno_tpu_torch/parallel/pipeline.py",
                                  "idunno_tpu_torch/engine/pipeline_lm.py",
                                  "idunno_tpu_torch/analysis/__main__.py",
                                  "idunno_tpu_torch/chaos_soak.py",
                                  "idunno_tpu_torch/entry.py",
                                  "idunno_tpu_torch/tools/__init__.py",
                                  "idunno_tpu_torch/tools/flash_sweep.py",
                                  "idunno_tpu_torch/tools/parse_trace.py",
                                  "idunno_tpu_torch/tools/mfu_roofline.py",
                                  "idunno_tpu_torch/tools/spec_trace.py",
                                  "idunno_tpu_torch/tools/"
                                  "two_model_fairshare.py",
                                  "idunno_tpu_torch/tools/metrics_scrape.py",
                                  "idunno_tpu_torch/tools/trace_export.py"])
def test_slice_modules_are_guarded(path):
    """The routed FFN's modules (and the CNNs' compute-dtype layers), the
    tensor-, sequence- and pipeline-parallel modules, the analyzer's and
    chaos soak's entry modules, ``entry()`` and the tools' counterparts are
    among the files the guard above reads, and import no JAX, nothing of
    the JAX package and nothing of the root's ``tools/``."""
    assert path in PORT_FILES
    test_port_file_imports_no_jax(path)


def _retarget(s: str) -> str:
    if s == "idunno_tpu" or s.startswith("idunno_tpu/"):
        return "idunno_tpu_torch" + s[len("idunno_tpu"):]
    return s


def _code_tree(text: str, rename: bool, strings: bool = False,
               drop: tuple = ()) -> str:
    """The module's syntax tree without docstrings, with ``idunno_tpu``
    read as ``idunno_tpu_torch`` in imports when ``rename`` (and in string
    constants naming the package's tree when ``strings``), and without the
    top-level assignments named in ``drop``."""
    tree = ast.parse(text)
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Assign) and any(
            getattr(x, "id", None) in drop for x in n.targets))]
    for node in ast.walk(tree):
        if strings and isinstance(node, ast.Constant) \
                and isinstance(node.value, str):
            node.value = _retarget(node.value)
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if rename and isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "idunno_tpu":
            node.module = "idunno_tpu_torch" + node.module[len("idunno_tpu"):]
        if rename and isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "idunno_tpu":
                    a.name = "idunno_tpu_torch" + a.name[len("idunno_tpu"):]
    return ast.dump(tree)


def _prose_lines(text: str) -> set[int]:
    """1-based numbers of the lines that hold only comments, docstrings or
    blanks, or end in a comment."""
    lines = set()
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            lines.update(range(body[0].lineno, body[0].end_lineno + 1))
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type == tokenize.COMMENT:
            lines.add(tok.start[0])
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            lines.add(i)
    return lines


@pytest.mark.parametrize("rel", COPIES)
def test_copy_keeps_the_jax_modules_code(rel):
    with open(os.path.join(REPO, "idunno_tpu", rel)) as f:
        ref = f.read()
    with open(os.path.join(PORT, rel)) as f:
        got = f.read()
    mine, theirs = _code_tree(got, rename=False), _code_tree(ref, rename=True)
    if mine != theirs:
        at = next((i for i, (x, y) in enumerate(zip(mine, theirs))
                   if x != y), min(len(mine), len(theirs)))
        lo = max(0, at - 60)
        pytest.fail(f"idunno_tpu_torch/{rel}: code differs from "
                    f"idunno_tpu/{rel} at\n  port: {mine[lo:at + 60]}"
                    f"\n  JAX:  {theirs[lo:at + 60]}")
    # the text differs only in comment and docstring lines: import lines
    # compare with the package renamed
    def norm(text):
        return [line.replace("idunno_tpu_torch", "idunno_tpu")
                if line.lstrip().startswith(("from ", "import ")) else line
                for line in text.splitlines()]
    a, b = norm(ref), norm(got)
    prose_a, prose_b = _prose_lines(ref), _prose_lines(got)
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op == "equal":
            continue
        assert all(i + 1 in prose_a for i in range(i1, i2)) and all(
            j + 1 in prose_b for j in range(j1, j2)), (
            f"idunno_tpu_torch/{rel}:{j1 + 1} differs from idunno_tpu/"
            f"{rel}:{i1 + 1} outside comments and docstrings:\n"
            + "\n".join(a[i1:i2] + ["---"] + b[j1:j2]))


@pytest.mark.parametrize("rel", sorted(RETARGETED_COPIES))
def test_retargeted_copy_keeps_the_jax_modules_code(rel):
    with open(os.path.join(REPO, "idunno_tpu", rel)) as f:
        ref = f.read()
    with open(os.path.join(PORT, rel)) as f:
        got = f.read()
    drop = tuple(RETARGETED_COPIES[rel])
    mine = _code_tree(got, rename=False, drop=drop)
    theirs = _code_tree(ref, rename=True, strings=True, drop=drop)
    assert mine == theirs, (
        f"idunno_tpu_torch/{rel}: code differs from idunno_tpu/{rel} "
        "once its strings name the port's tree")


def test_analyzer_registries_keep_the_jax_rows():
    """The port's registries keep every row of the JAX package's,
    retargeted; the port only adds rows (its own verbs, and one more
    guarded field of its control tier), and lints its own tree."""
    import dataclasses

    from idunno_tpu.analysis import contracts as jax_c
    from idunno_tpu.analysis import errorlint as jax_e
    from idunno_tpu_torch.analysis import contracts as port_c
    from idunno_tpu_torch.analysis import errorlint as port_e

    def re_row(row):
        out = {}
        for f in dataclasses.fields(row):
            v = getattr(row, f.name)
            if isinstance(v, str):
                v = _retarget(v)
            elif isinstance(v, tuple):
                v = tuple(tuple(_retarget(x) for x in a) if isinstance(
                    a, tuple) else _retarget(a) if isinstance(a, str)
                    else a for a in v)
            out[f.name] = v
        return dataclasses.astuple(dataclasses.replace(row, **out))

    def rows(registry):
        return [dataclasses.astuple(r) for r in registry]

    jax_verbs = [re_row(v) for v in jax_c.IDEM_VERBS]
    assert rows(port_c.IDEM_VERBS)[:len(jax_verbs)] == jax_verbs
    port_guards = {g[:3]: g for g in rows(port_c.GUARDED)}
    assert len(port_guards) == len(jax_c.GUARDED)
    for g in map(re_row, jax_c.GUARDED):
        assert set(g[3]) <= set(port_guards[g[:3]][3]), g
    assert port_e.BASELINE_TARGETS == ("idunno_tpu_torch", "chip_smoke.py")
    assert jax_e.BASELINE_TARGETS[0] == "idunno_tpu"


def _top_level(text: str) -> dict[str, str]:
    """Each top-level function and assignment of a module by name, as a
    syntax-tree dump without docstrings."""
    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.dump(node.value)
    return out


@pytest.mark.parametrize("rel", sorted(PARTIAL_COPIES))
def test_partial_copy_keeps_the_jax_definitions(rel):
    with open(os.path.join(REPO, "idunno_tpu", rel)) as f:
        ref = _top_level(f.read())
    with open(os.path.join(PORT, rel)) as f:
        got = _top_level(f.read())
    for name in PARTIAL_COPIES[rel]:
        assert name in ref and name in got, name
        assert got[name] == ref[name], (
            f"idunno_tpu_torch/{rel}:{name} differs from idunno_tpu/{rel}")


def _source_of(text: str, name: str) -> str:
    """The exact source text of top-level definition ``name``."""
    for node in ast.parse(text).body:
        if getattr(node, "name", None) == name or (
                isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == name
                        for t in node.targets)):
            return ast.get_source_segment(text, node)
    raise AssertionError(f"no top-level {name}")


@pytest.mark.parametrize("name", ["resnet_forward_flops",
                                  "alexnet_forward_flops",
                                  "vit_forward_flops"])
def test_bench_flop_counters_are_byte_equal_copies(name):
    """The port's bench keeps the repository bench's analytic FLOP
    counters byte for byte: the MFU denominators of both are one text."""
    with open(os.path.join(REPO, "bench.py")) as f:
        ref = f.read()
    with open(os.path.join(PORT, "bench.py")) as f:
        got = f.read()
    assert _source_of(got, name) == _source_of(ref, name)


# utils/loadgen.py: the definitions it copies from the load tools (path
# under the repository → names); PolicyProbe is left out, the port's copy
# repairs its manager surface (its docstring says how)
LOADGEN_COPIES = {
    "tools/gateway_load.py": ["DEFAULT_MIX", "poisson_schedule",
                              "run_open_loop"],
    "tools/autoscale_load.py": ["PHASES", "ReplicaRouter", "probe_decisions",
                                "interactive_p95", "run_phases",
                                "summarize"],
}


@pytest.mark.parametrize("tool", sorted(LOADGEN_COPIES))
def test_loadgen_keeps_the_load_tools_code(tool):
    with open(os.path.join(REPO, tool)) as f:
        ref = f.read()
    with open(os.path.join(PORT, "utils", "loadgen.py")) as f:
        got = f.read()
    for name in LOADGEN_COPIES[tool]:
        mine = _code_tree(_source_of(got, name), rename=False)
        theirs = _code_tree(_source_of(ref, name), rename=True)
        assert mine == theirs, f"utils/loadgen.py:{name} differs from {tool}"


# the tools' counterparts (``idunno_tpu_torch/tools/``): the definitions
# they keep from the repository's tools byte for byte, apart from import
# lines (path under the repository → names)
TOOL_COPIES = {
    "tools/trace_export.py": ["_RESERVED", "to_chrome", "from_chrome",
                              "waterfall", "selftest"],
    "tools/metrics_scrape.py": ["_SERIES", "scrape", "selftest"],
    "tools/mfu_roofline.py": ["conv_layer", "resnet18_layers",
                              "alexnet_layers"],
}


@pytest.mark.parametrize("tool", sorted(TOOL_COPIES))
def test_tool_counterparts_keep_the_tools_text(tool):
    with open(os.path.join(REPO, tool)) as f:
        ref = f.read()
    with open(os.path.join(PORT, tool)) as f:
        got = f.read()

    def text(src: str, name: str) -> list[str]:
        return [line.replace("idunno_tpu_torch", "idunno_tpu")
                if line.lstrip().startswith(("from ", "import ")) else line
                for line in _source_of(src, name).splitlines()]

    for name in TOOL_COPIES[tool]:
        assert text(got, name) == text(ref, name), (
            f"idunno_tpu_torch/{tool}:{name} differs from {tool}")
