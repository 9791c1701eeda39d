"""The kernels' build helpers (edgerunner_tpu_torch/ops/_build.py) on the CPU:
nothing here runs nvcc, which only the card's machine has."""

import os
import re

from edgerunner_tpu_torch.ops import _build
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN10edgerunner20flash_fwd_mma_kernelILi96EEEvPKv' for 'sm_90a'
ptxas info    : Function properties for _ZN10edgerunner20flash_fwd_mma_kernelILi96EEEvPKv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 444 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10edgerunner23flash_bwd_dkv_mma_kernelILi96EEEvPKv' for 'sm_90a'
ptxas info    : Function properties for _ZN10edgerunner23flash_bwd_dkv_mma_kernelILi96EEEvPKv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 456 bytes cmem[0]
"""


def test_ptxas_lines_parse_into_registers_and_spills_per_entry_function():
    kept = [ln.strip() for ln in PTXAS.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
    fns = _build.ptxas_functions(kept)
    assert len(fns) == 2
    assert "flash_fwd_mma_kernel" in fns[0]["name"]
    assert "flash_bwd_dkv_mma_kernel" in fns[1]["name"]
    assert (fns[0]["registers"], fns[0]["spill_stores"], fns[0]["spill_loads"]) == (126, 0, 0)
    assert (fns[1]["registers"], fns[1]["spill_stores"], fns[1]["spill_loads"]) == (255, 4, 4)


def test_every_c_entry_point_is_defined_in_a_source():
    """Each function the library binds by name is an extern "C" definition
    in one of the sources nvcc builds."""
    defined = {}
    for src in _build._sources():
        with open(src) as f:
            for name in re.findall(r'extern "C" int (\w+)\(', f.read()):
                defined[name] = os.path.basename(src)
    assert set(_build._SIGNATURES) <= set(defined)
    assert defined["flash_attention_fwd"] == "flash_fwd.cu"
    assert defined["flash_attention_bwd"] == "flash_bwd.cu"


def test_a_reused_library_reports_the_build_that_made_it(tmp_path, monkeypatch):
    """A library found in the build directory is loaded without nvcc, and
    what ptxas said when it was built comes back from beside it."""
    import ctypes
    import json
    import types

    out_dir = tmp_path / f"kernels-{_build._digest()}"
    out_dir.mkdir()
    (out_dir / "libedgerunner_kernels.so").write_bytes(b"")
    info = {"seconds": 12.5, "ptxas": [], "functions": [
        {"name": "flash_fwd_mma_kernel", "registers": 200, "spill_stores": 0, "spill_loads": 0}]}
    (out_dir / "build_info.json").write_text(json.dumps(info))
    fake = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in _build._SIGNATURES})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build_info", {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: fake)

    def no_nvcc(out_dir):
        raise AssertionError("a library in the build directory is not built again")

    monkeypatch.setattr(_build, "_compile", no_nvcc)
    assert _build.load_library() is fake
    assert _build.build_info["functions"] == info["functions"]
    assert _build.build_info["cached"] is True
