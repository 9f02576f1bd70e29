"""The port's examples run on the CPU, each in a subprocess of its own:
``examples/png_idat_torch.py`` (a PNG's IDAT chunk list decoded without
joining it, three ways, cross-checked) and
``examples/batch_pipeline_torch.py`` (batch, containment, pipeline, encode,
the distributed codec), with ``--device cpu`` at a small size.  After each
run the subprocess checks that neither jax nor ``defl_tpu`` was loaded.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = r"""
import runpy, sys
path, args = sys.argv[1], sys.argv[2:]
sys.argv = [path, *args]
runpy.run_path(path, run_name="__main__")
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "defl_tpu"))
assert not foreign, foreign
print("no jax, no defl_tpu")
"""


@pytest.mark.parametrize("name, args, lines", [
    ("png_idat_torch.py", ["--width", "24", "--height", "16"],
     ["host chunked decode: OK", "device chunked decode on cpu: OK",
      "zlib cross-check: OK"]),
    ("batch_pipeline_torch.py", ["--streams", "12"],
     ["inflate_batch: 12 streams ok", "containment: lane 3 ERR, 11 lanes ok",
      "DistributedCodec: 12 FDICT streams over 2 shard(s) ok"]),
])
def test_example_runs_on_the_cpu_without_jax(tmp_path, name, args, lines):
    path = os.path.join(REPO, "examples", name)
    r = subprocess.run([sys.executable, "-c", _RUN, path, "--device", "cpu",
                        *args], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.splitlines()
    for line in lines:
        assert line in out, (line, out)
    assert out[-1] == "no jax, no defl_tpu"


def test_examples_default_to_the_card(monkeypatch):
    """Without ``--device`` an example asks for CUDA, which raises here."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import png_idat_torch
    finally:
        sys.path.pop(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        png_idat_torch.main(["--width", "8", "--height", "4"])
