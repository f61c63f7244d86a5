"""No module of the benchmark imports JAX, its libraries or the JAX package
(``radardistill_tpu``), and the plain reference imports nothing of the
program (``radardistill_tpu_torch``) either. Each import's top-level name is
compared whole: the program's name begins with the JAX package's."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "radardistill_tpu"}
PROGRAM = "radardistill_tpu_torch"


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _files(sub=""):
    files = sorted((BENCH / sub).rglob("*.py"))
    assert files
    return files


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for f in _files():
        assert not _top_level_imports(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    files = _files("reference")
    assert len(files) > 20
    for f in files:
        assert PROGRAM not in _top_level_imports(f), f


def test_the_comparison_is_by_whole_top_level_name(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import radardistill_tpu_torch.models\nfrom radardistill_tpu.ops import x\n")
    names = _top_level_imports(probe)
    assert names == {"radardistill_tpu_torch", "radardistill_tpu"}
    assert names & FORBIDDEN == {"radardistill_tpu"}


def test_the_harness_reaches_the_program_only_inside_functions():
    """The program is imported where a run starts, never when the harness's
    modules are imported, so its files and the JAX check stay apart."""
    for f in _files("lib") + [BENCH / "run.py"]:
        tree = ast.parse(f.read_text())
        top = {a.name.split(".")[0] for n in tree.body if isinstance(n, ast.Import)
               for a in n.names}
        top |= {n.module.split(".")[0] for n in tree.body
                if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module}
        assert PROGRAM not in top, f
