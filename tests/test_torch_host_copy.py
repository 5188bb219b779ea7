"""The port's host tier is a verbatim copy of the reference's, and the port
loads neither JAX nor the reference package."""
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "vvctpu", ROOT / "vvctpu_torch"

COPIED = ["core/__init__.py", "core/rom.py", "core/tables_spec.py",
          "core/bitstream.py", "core/trace.py", "cabac/__init__.py",
          "cabac/binarize.py", "cabac/contexts.py", "cabac/engine.py",
          "cabac/native.py", "io/__init__.py", "io/yuv.py",
          "io/streamtools.py", "pipeline/__init__.py", "pipeline/entropy.py",
          "pipeline/plan.py", "kernels/__init__.py", "coding/__init__.py"] \
    + sorted(f"spec/{p.name}" for p in (REF / "spec").glob("*.py"))


@pytest.mark.parametrize("rel", COPIED)
def test_copied_file_identical(rel):
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes(), rel


def test_estimate_copy_drops_only_jnp_twins():
    ref = (REF / "cabac/estimate.py").read_text()
    port = (PORT / "cabac/estimate.py").read_text()
    cut = ref.index("\n\n\n# --- device-side twin")
    assert port == ref[:cut] + "\n"
    assert "def _fb_j" in ref[cut:] and "def tx_tables_j" in ref[cut:]


def test_fresh_import_loads_no_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, vvctpu_torch\n"
        "for m in pkgutil.walk_packages(vvctpu_torch.__path__, "
        "'vvctpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'vvctpu')]\n"
        "print(len([k for k in sys.modules if k.startswith('vvctpu_torch')]))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 30


_BAD_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|vvctpu)(\.|\s|$)",
                         re.M)


def test_no_jax_or_reference_import_in_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        m = _BAD_IMPORT.search(f.read_text())
        assert m is None, f"{f}: {m.group(0) if m else ''}"


def test_bitlen_arr_copy_identical():
    """decide._bitlen_arr, the host rate helper of the GPM decision, is a
    verbatim copy of the reference's and gives the same bit lengths."""
    import inspect

    import numpy as np
    pytest.importorskip("jax")
    from vvctpu.coding import decide as jdecide
    from vvctpu_torch.coding import decide as tdecide
    assert (inspect.getsource(tdecide._bitlen_arr)
            == inspect.getsource(jdecide._bitlen_arr))
    v = np.arange(-70000, 70000, 7, dtype=np.int32)
    np.testing.assert_array_equal(tdecide._bitlen_arr(v),
                                  jdecide._bitlen_arr(v))
