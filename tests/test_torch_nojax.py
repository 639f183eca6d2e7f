"""The PyTorch port stands alone: it imports neither JAX/Flax nor the JAX
package (nor cv2, imageio or PIL), and reads nothing under /root/reference.
``chip_smoke.py`` likewise. Importing it needs no ``regex`` either: the BPE
tokenizer imports it only when one is built (the card machine has none)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "upscale_a_video_tpu_torch"
FORBIDDEN = ("jax", "flax", "upscale_a_video_tpu", "cv2", "imageio", "PIL")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_forbidden(path):
    text = path.read_text()
    assert "/root/reference" not in text
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_port_and_chip_smoke_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'upscale_a_video_tpu', 'cv2', 'imageio', 'PIL', 'regex'):\n"
        "    sys.modules[m] = None\n"
        "import upscale_a_video_tpu_torch, upscale_a_video_tpu_torch.pipeline\n"
        "import upscale_a_video_tpu_torch.ops.flash_attention\n"
        "import upscale_a_video_tpu_torch.ops.fused_temporal_resblock\n"
        "import upscale_a_video_tpu_torch.ops.fused_temporal_attention\n"
        "import upscale_a_video_tpu_torch.ops.fused_groupnorm\n"
        "import upscale_a_video_tpu_torch.ops.temporal_conv\n"
        "import upscale_a_video_tpu_torch.ops.resize\n"
        "import upscale_a_video_tpu_torch.pipeline.color\n"
        "import upscale_a_video_tpu_torch.pipeline.loader\n"
        "import upscale_a_video_tpu_torch.models.raft\n"
        "import upscale_a_video_tpu_torch.models.propagation\n"
        "import upscale_a_video_tpu_torch.ops.warp\n"
        "import upscale_a_video_tpu_torch.utils.clip_bpe\n"
        "import upscale_a_video_tpu_torch.utils.flow_viz\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
        "'upscale_a_video_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the script exits non-zero and prints no result line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
