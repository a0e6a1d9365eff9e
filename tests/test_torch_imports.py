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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "idunno_tpu_torch")
BANNED = ("jax", "flax", "optax", "idunno_tpu")

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
]


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


def _code_tree(text: str, rename: bool) -> str:
    """The module's syntax tree without docstrings, with ``idunno_tpu``
    read as ``idunno_tpu_torch`` in imports when ``rename``."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
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
