"""The PyTorch port stands alone: it imports neither JAX/Flax nor the JAX
package anywhere, and reads nothing from the reference implementation's
checkout; ``chip_smoke.py`` likewise. The codec libraries cv2, imageio and
PIL (which the card machine lacks) are imported only inside the functions
of ``utils/video_io.py`` that use them, never at module level. Importing
the port needs none of these, and no ``regex`` either: the BPE tokenizer
imports it only when one is built; nor ``transformers`` or ``safetensors``,
which the LLaVA loader imports only when it loads."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "upscale_a_video_tpu_torch"
FORBIDDEN = ("jax", "flax", "upscale_a_video_tpu")
CODECS = ("cv2", "imageio", "PIL")
CODEC_USER = PORT / "utils" / "video_io.py"  # the one module whose functions may import them


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(top-level package name, inside a function body) of every absolute import."""
    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            inside = in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                       ast.Lambda))
            if isinstance(child, ast.Import):
                yield from ((a.name.split(".")[0], inside) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield (child.module or "").split(".")[0], inside
            yield from walk(child, inside)
    return walk(tree, False)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_forbidden(path):
    text = path.read_text()
    assert "/root/reference" not in text
    for name, in_function in _imports(ast.parse(text)):
        assert name not in FORBIDDEN, f"{path.name} imports {name}"
        if name in CODECS:
            where = "in a function" if in_function else "at module level"
            assert in_function and path == CODEC_USER, f"{path.name} imports {name} {where}"


def test_codec_rule_reads_function_bodies():
    """The rule above tells a codec import in a function from one at module
    (or class) level."""
    tree = ast.parse("import os\nclass A:\n    import PIL\n"
                     "def f():\n    import cv2\n    from imageio import v3\n")
    assert list(_imports(tree)) == [("os", False), ("PIL", False), ("cv2", True),
                                    ("imageio", True)]


def test_port_and_chip_smoke_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'upscale_a_video_tpu', 'cv2', 'imageio', 'PIL', 'regex',\n"
        "          'transformers', 'safetensors'):\n"
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
        "import upscale_a_video_tpu_torch.utils.video_io\n"
        "import upscale_a_video_tpu_torch.utils.native_frameproc\n"
        "import upscale_a_video_tpu_torch.pipeline.tiling\n"
        "import upscale_a_video_tpu_torch.pipeline.tiled_run\n"
        "import upscale_a_video_tpu_torch.pipeline.vae_tiling\n"
        "import upscale_a_video_tpu_torch.pipeline.graphs\n"
        "import upscale_a_video_tpu_torch.models.llava\n"
        "import upscale_a_video_tpu_torch.models.llava.clip_vision\n"
        "import upscale_a_video_tpu_torch.models.llava.llama\n"
        "import upscale_a_video_tpu_torch.models.llava.mpt\n"
        "import upscale_a_video_tpu_torch.models.llava.llava\n"
        "import upscale_a_video_tpu_torch.models.llava.conversation\n"
        "import upscale_a_video_tpu_torch.models.llava.convert\n"
        "import upscale_a_video_tpu_torch.models.llava.loader\n"
        "import upscale_a_video_tpu_torch.utils.quant\n"
        "import upscale_a_video_tpu_torch.captioner\n"
        "import upscale_a_video_tpu_torch.cli\n"
        "import upscale_a_video_tpu_torch.serving\n"
        "import upscale_a_video_tpu_torch.serving.predictor\n"
        "import upscale_a_video_tpu_torch.serving.controller\n"
        "import upscale_a_video_tpu_torch.serving.worker\n"
        "import upscale_a_video_tpu_torch.serving.caption_worker\n"
        "import upscale_a_video_tpu_torch.serving.web_demo\n"
        "import upscale_a_video_tpu_torch.utils.stream\n"
        "import upscale_a_video_tpu_torch.utils.checkpoint\n"
        "import upscale_a_video_tpu_torch.utils.metrics\n"
        "import upscale_a_video_tpu_torch.utils.lpips\n"
        "import upscale_a_video_tpu_torch.pipeline.eval\n"
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
