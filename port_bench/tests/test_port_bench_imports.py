"""What the benchmark imports: nothing of JAX or of the JAX package
anywhere, and nothing of the port in its reference, its scenes or its
yardstick.  Top-level module names are compared whole: the port's name,
contrast_renderer_tpu_torch, begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from port_bench.harness import cell as cell_mod

BENCH = cell_mod.BENCH_DIR
JAX = {"jax", "jaxlib", "flax", "contrast_renderer_tpu"}
PORT = "contrast_renderer_tpu_torch"
#: The only file that reaches the port: the scene's names and its renderer.
PORT_USERS = {"harness/port_lib.py"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_the_port_only_where_it_is_driven(path):
    tops = imported_tops(path)
    assert not tops & JAX, f"{path} imports {tops & JAX}"
    rel = str(path.relative_to(BENCH))
    if rel not in PORT_USERS:
        assert PORT not in tops, f"{rel} imports the port"


def test_whole_name_comparison():
    mods = ["contrast_renderer_tpu_torch.renderer", "jaxtyping", "numpy",
            "contrast_renderer_tpu.ops", "jax.numpy", "flax"]
    assert cell_mod.forbidden_modules(mods) == ["contrast_renderer_tpu.ops", "flax", "jax.numpy"]


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import port_bench.reference.scene, port_bench.reference.raster;"
        "import port_bench.harness.roofline, port_bench.harness.check;"
        "import port_bench.scenes.showcase, port_bench.scenes.dashed_strokes;"
        "import port_bench.scenes.bezier_fills, port_bench.harness.settle;"
        "import port_bench.metrics.raster_roofline;"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('contrast_renderer_tpu_torch', 'contrast_renderer_tpu', 'jax', 'jaxlib', 'flax')];"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code, str(cell_mod.ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_port_side_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from port_bench.harness import port_lib, cell;"
        "import port_bench.entries.frame_program, port_bench.entries.render;"
        "port_lib.lib(); port_lib.load_native(); port_lib.nvcc_seconds();"
        "bad = cell.forbidden_modules(sys.modules); print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code, str(cell_mod.ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
