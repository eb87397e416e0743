"""The port stands alone: nothing under ``src/repro_torch/``, in
``chip_smoke.py`` or in the port's ``scripts/`` imports JAX, the JAX
package or ``msgpack``, and the package with its entry points imports (and
writes and reads a checkpoint) in a process where ``jax``, ``repro``,
``msgpack`` and ``zstandard`` cannot be imported: the card's machine has
no ``msgpack`` and may lack ``zstandard``, which the checkpoint module looks
up only when it compresses."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "scripts").glob("*.py"))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    pytest.importorskip("torch")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['zstandard'] = None\n"
        "import repro_torch, repro_torch.bridge, repro_torch.kernels.ops\n"
        "from repro_torch.federated import FLRun, setup_clients, make_fleet\n"
        "from repro_torch.models import init_params\n"
        "from repro_torch.configs import ALEXNET, HeliosConfig, reduced\n"
        "import repro_torch.kernels.build, repro_torch.kernels.masked_matmul\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.models.hybrid\n"
        "import repro_torch.federated.events\n"
        "from repro_torch.federated import (JitteredArrival, "
        "BernoulliDropout, SimClock, AsynScheme, AfoScheme)\n"
        "from repro_torch.configs import RESNET18\n"
        "from repro_torch.models.cnn import resnet18_fwd\n"
        "from repro_torch.configs import GRANITE_MOE_1B_A400M\n"
        "from repro_torch.models import build, moe\n"
        "assert build(GRANITE_MOE_1B_A400M).mask_schema\n"
        "from repro_torch.federated import (ScaffoldScheme, FluidScheme, "
        "DelayedScheme)\n"
        "from repro_torch.core import theory\n"
        "from repro_torch.optim.compression import HostErrorStore\n"
        "from repro_torch.optim.compression import (compress_update, "
        "compress_update_stacked, quantize)\n"
        "from repro_torch.core.aggregation import (lossy_roundtrip, "
        "ring_gather_lossy, mix_bucket_ring_lossy, SnapshotRing)\n"
        "import repro_torch.drivers.scheme_gauntlet\n"
        "import repro_torch.drivers.heterogeneous_fl\n"
        "import repro_torch.drivers.serve_while_train\n"
        "import repro_torch.drivers.federated_lm\n"
        "import repro_torch.launch.mesh, repro_torch.drivers.population_scale\n"
        "from repro_torch.federated import ShardedFLRun\n"
        "assert repro_torch.launch.mesh.make_client_group(4, 'cpu').size == 1\n"
        "import repro_torch.obs, repro_torch.obs.report\n"
        "import repro_torch.obs.__main__\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.wire\n"
        "import repro_torch.launch, repro_torch.launch.serve\n"
        "import repro_torch.launch.serve.__main__\n"
        "from repro_torch.launch.serve import (GenerationServer, ServeLoop, "
        "PoissonTraffic, make_ce_eval, serve_while_training, main)\n"
        "from repro_torch.models.transformer import lm_prefill, lm_decode\n"
        "from repro_torch.models.hybrid import hybrid_prefill, "
        "hybrid_decode\n"
        "from repro_torch.models.ssm import mamba2_decode\n"
        "from repro_torch.configs import get_model_config\n"
        "assert build(get_model_config('zamba2-1.2b')).prefill_fn\n"
        "import repro_torch.launch.train, repro_torch.launch.steps\n"
        "import repro_torch.models.xlstm\n"
        "from repro_torch.launch.steps import (make_train_step, "
        "make_fl_round_step, init_train_state)\n"
        "from repro_torch.optim import adamw, warmup_cosine_schedule\n"
        "for name in ('xlstm-125m', 'internvl2-1b'):\n"
        "    api = build(get_model_config(name))\n"
        "    assert api.mask_schema and api.prefill_fn and api.decode_fn\n"
        "assert build(get_model_config('xlstm-125m')).cfg.family == 'ssm'\n"
        "assert build(get_model_config('internvl2-1b')).cfg.family == 'vlm'\n"
        "from repro_torch.models.mla import mla_fwd, mla_decode\n"
        "from repro_torch.models.encdec import (encdec_loss, "
        "encdec_prefill, encdec_decode)\n"
        "from repro_torch.configs import (DEEPSEEK_V2_236B, "
        "SEAMLESS_M4T_LARGE_V2, ARCHS)\n"
        "assert len(ARCHS) == 10\n"
        "for c in (DEEPSEEK_V2_236B, SEAMLESS_M4T_LARGE_V2):\n"
        "    api = build(reduced(c))\n"
        "    assert api.mask_schema and api.prefill_fn and api.decode_fn\n"
        "    init_params(reduced(c), 0, 'cpu')\n"
        "assert not any(m.split('.')[0] in ('jax', 'repro', 'msgpack', "
        "'zstandard') for m, v in sys.modules.items() if v is not None)\n"
        "import tempfile, torch\n"
        "d = tempfile.mkdtemp()\n"
        "repro_torch.checkpoint.save(d, 1, {'w': torch.ones(3)})\n"
        "assert repro_torch.checkpoint.codec_name() == 'zlib'\n"
        "out, _ = repro_torch.checkpoint.restore(d, {'w': torch.zeros(3)})\n"
        "assert out['w'].tolist() == [1.0, 1.0, 1.0]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_import_sets_up_every_mkl_vml_function():
    """Importing the package calls, on one element, every torch CPU math
    function that runs on MKL's vector math library (a kernel named
    ``<op>_vml_cpu``): the first call of such a function made by several
    OpenMP threads at once can return wrong values (``repro_torch``'s
    docstring, ROADMAP.md section 3)."""
    torch = pytest.importorskip("torch")
    import repro_torch
    unary = ("abs", "acos", "acosh", "asin", "asinh", "atan", "atanh",
             "ceil", "cos", "cosh", "digamma", "erf", "erfc", "erfinv",
             "exp", "exp2", "expm1", "floor", "frac", "i0", "lgamma", "log",
             "log10", "log1p", "log2", "neg", "reciprocal", "round", "rsqrt",
             "sigmoid", "sign", "sin", "sinc", "sinh", "sqrt", "tan", "tanh",
             "trunc")
    vml = set()
    for name in unary:
        try:
            getattr(torch, name)(torch.zeros(2, dtype=torch.complex32))
        except Exception as e:           # the kernel's name is in the error
            if f'"{name}_vml_cpu"' in str(e):
                vml.add(name)
    assert "exp" in vml and "rsqrt" not in vml
    assert vml <= set(repro_torch._VML_FUNCTIONS), vml
