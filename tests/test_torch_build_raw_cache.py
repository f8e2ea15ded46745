"""``tools/build_raw_cache_torch.py`` against the JAX tool it ports
(``tools/build_raw_cache.py``): the same flags write byte-identical cache
files for a tiny synthetic split of JPEGs (``tests/test_torch_data.py``'s
``write_split``: 130 x 116 frames, cached at 112 x 126, so every frame is
resized), and the tool runs as a script without loading jax or anything of
the JAX package."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import tools.build_raw_cache as jax_tool
import tools.build_raw_cache_torch as tool
from test_torch_data import SIZE_WH, write_split

REPO = Path(__file__).resolve().parent.parent
FLAGS = ["--split", "val", "--width", str(SIZE_WH[0]), "--height", str(SIZE_WH[1])]


def cache_files(root) -> dict:
    """relpath -> bytes of every cache file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("rawcache_*"))}


@pytest.mark.parametrize("scenes", [[], ["--scenes", "s00001"]])
def test_both_tools_write_the_same_bytes(tmp_path, monkeypatch, scenes):
    write_split(tmp_path / "jax", splits=(("val", ("s00000", "s00001")),), n_queries=3)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["build_raw_cache.py", "--dataset", str(tmp_path / "jax"), *FLAGS, *scenes])
    jax_tool.main()
    tool.main(["--dataset", str(tmp_path / "port"), *FLAGS, *scenes])
    ref, ours = cache_files(tmp_path / "jax"), cache_files(tmp_path / "port")
    w, h = SIZE_WH
    names = {f"rawcache_{w}x{h}.u8", f"rawcache_{w}x{h}.json"}
    built = ["s00001"] if scenes else ["s00000", "s00001"]
    assert sorted(ref) == sorted(f"val/{s}/{n}" for s in built for n in names)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == ref[k], k


def test_the_tool_leaves_jax_out(tmp_path):
    """An AST scan of the tool, then the tool run as a script: it builds the
    caches and loads neither jax, orbax nor any module of the JAX package."""
    for node in ast.walk(ast.parse((REPO / "tools" / "build_raw_cache_torch.py").read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not [n for n in names if n.split(".")[0] in ("jax", "mickey_tpu", "orbax")], names
    write_split(tmp_path, splits=(("val", ("s00000",)),), n_queries=2)
    code = ("import runpy, sys\n"
            f"sys.argv = ['build_raw_cache_torch.py', '--dataset', {str(tmp_path)!r}] + {FLAGS!r}\n"
            "runpy.run_path('tools/build_raw_cache_torch.py', run_name='__main__')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mickey_tpu', 'orbax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(REPO))
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "cached 3 frames" in out.stdout
    assert len(cache_files(tmp_path)) == 2
