"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name, tpu_mpc_torch, begins with the JAX
package's), and the reference, the roofline counts and the key generator
import nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench import harness

BENCH = harness.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_mpc"}


def modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every import in a file, relative ones as
    'portbench'."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("portbench" if node.level else node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(arg.value.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    found = {os.path.relpath(p, BENCH): imported(p) & FORBIDDEN for p in modules()}
    assert not {k: v for k, v in found.items() if v}
    # the module list of the instrument is the port's, not the JAX package's
    from portbench import instrument

    assert {m.split(".")[0] for m, _ in instrument.LAUNCHERS.values()} == {"tpu_mpc_torch"}


def test_reference_roofline_and_keys_import_nothing_of_the_program():
    for sub in ("reference", "roofline", "keys"):
        for p in modules():
            if os.path.relpath(p, BENCH).startswith(sub + os.sep):
                assert "tpu_mpc_torch" not in imported(p), p
    code = ("import sys; import portbench.reference.judge, portbench.roofline, "
            "portbench.keys.make_keys, portbench.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'tpu_mpc_torch', 'tpu_mpc', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(BENCH),
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "tpu_mpc_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxy", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_mpc.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "tpu_mpc"]
