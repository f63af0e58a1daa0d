"""Nothing the benchmark runs imports JAX or the JAX package ``repro``:
top-level module names compared whole, so ``repro_torch`` passes."""

import ast
import pathlib
import subprocess
import sys
import types

from portbench import harness

PKG = pathlib.Path(harness.__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    for path in PKG.rglob("*.py"):
        for name in _imports(path):
            if name.partition(".")[0] in BANNED:
                found.setdefault(str(path.relative_to(PKG)), []).append(name)
    assert not found


def test_the_references_import_nothing_of_the_program():
    """The plain references (``reference/``) read no module of the port,
    in their sources and when imported alone."""
    for path in (PKG / "reference").glob("*.py"):
        assert not [n for n in _imports(path) if n.partition(".")[0] in BANNED | {"repro_torch"}]
    code = ("import sys; import portbench.reference.knn, portbench.reference.propagation, "
            "portbench.reference.stream; "
            "print(sorted({m.partition('.')[0] for m in sys.modules} & {'repro_torch', 'repro', "
            "'jax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_program_hooks_name_the_port_only():
    from portbench import layers
    from portbench.spans import Hook

    for h in vars(layers).values():
        if isinstance(h, Hook):
            assert h.target.partition(":")[0].partition(".")[0] == "repro_torch"


def test_runtime_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("repro_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxtyping_stub", types.ModuleType("jaxtyping_stub"))
    assert "repro" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert {"repro", "jax"} <= set(harness.banned_modules())


def test_a_tiny_run_loads_neither():
    import time

    before = set(harness.banned_modules())
    harness.run("amazon-polarity-nomic128.fit", 3, 0.01, False, t_start=time.perf_counter(),
                device="cpu", overrides={"vertices": 1000})
    assert set(harness.banned_modules()) == before
