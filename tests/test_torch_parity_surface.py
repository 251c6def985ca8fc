"""Every public name of the JAX package has its counterpart in the port.

Both packages are walked with ``ast`` (nothing is imported): for each
module of ``meters_lv2_tpu`` its public module-level functions, classes
(with their public methods) and constants must be names of the same module
of ``meters_lv2_torch``, defined there or imported into it.  The exceptions
are listed below with their reasons (ROADMAP.md, queue A).
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# what the port leaves out on purpose, and why
LEFT_OUT = {
    # the Pallas kernels: each has a hand-written CUDA kernel in
    # meters_lv2_torch/csrc with its wrapper in meters_lv2_torch/ops
    **{f"ops/pallas_{k}.py": "a Pallas kernel; ported as csrc/*.cu and its ops/ wrapper"
       for k in ("ballistics", "bitmeter", "r128", "spectrum", "stft", "surround", "truepeak")},
    "ops/bf16split.py": "a Mosaic precision workaround; the port runs IEEE fp32",
    "ops/swar.py": "the XLA bit-count tree of the JAX bit meter; csrc/bitmeter_stats.cu "
                   "replaces it",
    "ops/fft.py::GemmRFFT": "the METERS_TPU_STFT_GEMM diagnostic path, refuted on the TPU",
    "ops/fft.py::GemmRFFT.supports": "as GemmRFFT",
    "ops/lti.py::LTIBlockOp.tree_flatten": "a JAX pytree hook",
    "ops/lti.py::LTIBlockOp.tree_unflatten": "a JAX pytree hook",
}


def _public(name: str) -> bool:
    return not any(part.startswith("_") for part in name.split("."))


def public_names(pkg: str, with_imports: bool) -> dict:
    """{module path: public module-level names}; with_imports also counts
    names a module imports (a re-export is a counterpart)."""
    root = ROOT / pkg
    out = {}
    for f in sorted(root.rglob("*.py")):
        names = set()
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
            elif isinstance(node, ast.ClassDef):
                names.add(node.name)
                names |= {f"{node.name}.{sub.name}" for sub in node.body
                          if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))}
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
                names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        out[f.relative_to(root).as_posix()] = {n for n in names if _public(n)}
    return out


JAX = public_names("meters_lv2_tpu", with_imports=False)
PORT = public_names("meters_lv2_torch", with_imports=True)


@pytest.mark.parametrize("module", sorted(JAX))
def test_module_has_its_counterparts(module):
    if module in LEFT_OUT:
        assert module not in PORT, f"{module} is listed as left out but the port has it"
        return
    assert module in PORT, f"meters_lv2_torch/{module} is missing"
    missing = sorted(n for n in JAX[module] - PORT[module] if f"{module}::{n}" not in LEFT_OUT)
    assert not missing, f"meters_lv2_torch/{module} lacks {missing}"


def test_left_out_list_is_current():
    """Every exception names something the JAX package has and the port
    does not."""
    for key in LEFT_OUT:
        module, _, name = key.partition("::")
        assert module in JAX, key
        if name:
            assert name in JAX[module] and name not in PORT.get(module, set()), key


def test_last_names_match_values():
    """The names this surface walk found missing last, with the JAX
    package's values."""
    import torch

    from meters_lv2_torch.models import bitmeter as tbit
    from meters_lv2_torch.ops import resample as tres
    from meters_lv2_tpu.models import bitmeter as jbit
    from meters_lv2_tpu.ops import resample as jres

    assert tbit.NPOS == jbit.NPOS == 280
    h = tres.upsample4_init((3, 2), device="cpu")
    j = jres.upsample4_init((3, 2))
    assert tuple(h.shape) == tuple(j.shape) == (3, 2, 47)
    assert h.dtype == torch.float32 and not h.any()
    assert tres.upsample4_init(dtype=torch.float64, device="cpu").dtype == torch.float64
