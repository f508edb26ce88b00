"""No module under hnsw_bench/ imports JAX or the JAX package, and the
reference's files import nothing of the port."""

from pathlib import Path

from hnsw_bench import imports

HERE = Path(imports.__file__).resolve().parent


def test_benchmark_imports_no_jax_and_reference_no_port():
    assert imports.violations(HERE) == []


def test_names_are_compared_whole(tmp_path):
    (tmp_path / "a.py").write_text(
        "import ocaml_hnsw_tpu_torch.api\nfrom jaxtyping import x\n")
    (tmp_path / "b.py").write_text("import os\nimport jax.numpy as jnp\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "c.py").write_text(
        "from ocaml_hnsw_tpu.models import flat\n")
    (tmp_path / "d.py").write_text(
        "import importlib\nimportlib.import_module('flax.linen')\n")
    (tmp_path / "reference.py").write_text(
        "from ocaml_hnsw_tpu_torch.ops import metrics\n")
    assert imports.violations(tmp_path) == [
        "b.py: jax", "d.py: flax", "reference.py: ocaml_hnsw_tpu_torch",
        "sub/c.py: ocaml_hnsw_tpu"]


def test_loaded_forbidden_reads_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "ocaml_hnsw_tpu_torch_x",
                        types.ModuleType("ocaml_hnsw_tpu_torch_x"))
    assert "ocaml_hnsw_tpu" not in imports.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    assert "jaxlib" in imports.loaded_forbidden()
