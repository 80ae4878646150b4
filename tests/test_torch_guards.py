"""Guards of the port's boundaries: it (and the examples' twins) imports
neither jax nor the JAX package nor its benchmarks, it never runs silently on the CPU when asked for CUDA, and the
GPU smoke test refuses to report a result without a GPU."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import StageServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro|benchmarks)(\.|\s|$)",
                       re.MULTILINE)
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("*_torch.py")))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_importing_port_entry_points_leaves_jax_unloaded():
    code = ("import sys, repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.api, repro_torch.cluster.env, repro_torch.cluster.executor, "
            "repro_torch.cluster.calibration, repro_torch.models.whisper, "
            "repro_torch.models.xlstm_lm, repro_torch.launch.calibrate; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                                                      "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        StageServer("s", [ARCHS["llama3.2-1b"].smoke()])
    with pytest.raises(RuntimeError, match="is_available"):
        api.init_model(0, ARCHS["llama3.2-1b"].smoke())
    with pytest.raises(RuntimeError, match="is_available"):
        api.init_cache(ARCHS["llama3.2-1b"].smoke(), 1, 8)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_launcher_decodes_on_cpu(capsys):
    run = serve.main(["--device", "cpu", "--tokens", "3", "--batch", "2", "--context", "8"])
    assert run.tokens.shape == (2, 3) and run.prompt.shape == (2, 1)
    assert run.logits is None
    assert "decoded 6 tokens" in capsys.readouterr().out


def test_decode_loop_keeps_logits_and_feeds_back_argmax():
    cfg = ARCHS["llama3.2-1b"].smoke()
    model = api.init_model(0, cfg, device="cpu")
    run = serve.decode_loop(model, cfg, batch=2, context=8, tokens=4, keep_logits=True)
    assert tuple(run.logits.shape) == (2, 4, cfg.vocab)
    assert np.array_equal(run.logits.argmax(-1).numpy(), run.tokens)


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                       "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_gpu():
    res = _smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
