"""No module of the benchmark, nor anything a run of it imports, has the
top-level name jax, jaxlib, flax or ducosy_tpu; the reference imports
nothing of the port. Names are compared whole: the port's name begins
with the JAX package's."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ducosy_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "ducosy_tpu_torch" not in _imports(f), f


BLOCK = textwrap.dedent('''
    import importlib.abc, sys
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
    sys.meta_path.insert(0, Block())
''')


def _run(code: str, blocked: set) -> subprocess.CompletedProcess:
    src = f"BLOCKED = {sorted(blocked)!r}\n" + BLOCK + textwrap.dedent(code)
    return subprocess.run([sys.executable, "-c", src], cwd=BENCH.parent,
                          capture_output=True, text=True, timeout=600)


def test_a_dry_run_loads_no_jax():
    """Both drivers run at tiny sizes on the CPU, with JAX and the JAX
    package unimportable; afterwards sys.modules holds neither."""
    proc = _run('''
        import copy, sys, time
        sys.path.insert(0, ".")
        from portbench.harness import card, serve_closed_loop, train_pool
        from portbench.harness.common import Ctx
        from portbench.harness.spec import Spec
        spec = Spec()
        for cell, driver in (("serve-thick-512", serve_closed_loop),
                             ("train-soft-512-b8", train_pool)):
            c = spec.cell(cell)
            config = copy.deepcopy(spec.config(c["config"]))
            traffic = copy.deepcopy(spec.traffic(c["traffic"]))
            config["img_size"] = 32
            config["compute_dtype"] = "float32"
            config["generator"].update(base_channels=8, num_residual_blocks=2)
            config.get("discriminator", {}).update(base_channels=8)
            traffic.update(sizes=[3, 5], chunk=2, sample=2, batch=2,
                           batches=3, warmup_steps=3,
                           dispatch_probe_steps=1)
            out = driver.run(Ctx(seed=7, seconds=0.2, trace=True,
                                 config=config, traffic=traffic,
                                 t0=time.perf_counter(), device="cpu",
                                 check_path=False))
            assert out.correct, out.checks
        print("held", card.forbidden_modules())
    ''', FORBIDDEN)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "held []"


def test_the_reference_runs_without_the_port():
    proc = _run('''
        import sys
        sys.path.insert(0, ".")
        import torch
        from portbench.reference import cyclegan, losses, nets, serve
        assert not any(m.split(".")[0] == "ducosy_tpu_torch"
                       for m in sys.modules)
        print("ok")
    ''', FORBIDDEN | {"ducosy_tpu_torch"})
    assert proc.returncode == 0, proc.stderr[-3000:]
