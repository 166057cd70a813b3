"""What the benchmark may load and read. Top-level module names are
compared whole, so the port (whose name begins with the JAX package's)
passes where the JAX package would not:
- no file under ``benchmark/`` imports JAX, flax, optax or the JAX package;
- the plain reference imports nothing of the port either;
- no file names the JAX package's benchmark script or its records."""

import ast
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "contrast_gan_3d_tpu"}
PORT = "contrast_gan_3d_tpu_torch"
# the JAX package's benchmark script and records, spelled so this file does not match itself
RECORDS = re.compile(r"\b(" + "bench" + r"\.py|" + "BENCH" + r"_[\w*]*\.json|" + "MULTICHIP" + r"_[\w*]*\.json|"
                     + "BASELINE" + r"\.json)")


def imported_top_levels(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_files_are_found():
    assert len(FILES) > 10 and BENCH / "run.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_the_jax_side(path):
    assert imported_top_levels(path).isdisjoint(JAX_SIDE)


@pytest.mark.parametrize("path", [p for p in FILES if "reference" in p.relative_to(BENCH).parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_top_levels(path)
    assert PORT not in path.read_text()


@pytest.mark.parametrize("path", [p for p in BENCH.rglob("*") if p.is_file() and "__pycache__" not in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_names_the_jax_records(path):
    assert not RECORDS.search(path.read_text(errors="replace"))


def test_whole_name_comparison(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import contrast_gan_3d_tpu_torch.models\nfrom contrast_gan_3d_tpu.models import x\n")
    assert imported_top_levels(probe) == {"contrast_gan_3d_tpu_torch", "contrast_gan_3d_tpu"}
    assert RECORDS.search("open('" + "bench" + ".py')") and not RECORDS.search("run_" + "bench" + ".py")
    assert RECORDS.search("BENCH" + "_r01.json") and RECORDS.search("glob('" + "MULTICHIP" + "_*.json')")
