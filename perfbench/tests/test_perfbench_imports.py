"""In a fresh process: the harness and the reference load no module of JAX,
jaxlib, Flax or the JAX package (top-level names compared whole: the
port's name begins with the JAX package's), and the reference loads
nothing of the port; nor does a whole run on the CPU, the port included."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, body=body)],
                         capture_output=True, text=True, check=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


FORBIDDEN = {"jax", "jaxlib", "flax", "gemm_gan_tpu"}


def test_harness_and_reference_import_no_jax():
    mods = top_level("import perfbench.run, perfbench.calibrate, perfbench.check\n"
                     "import perfbench.reference.film_cross_attention, "
                     "perfbench.reference.wgan_step, perfbench.cells.train_epochs, "
                     "perfbench.flops.film_cross_attention")
    assert not mods & FORBIDDEN


def test_reference_imports_no_port():
    mods = top_level("import perfbench.reference.film_cross_attention, "
                     "perfbench.reference.wgan_step")
    assert "gemm_gan_tpu_torch" not in mods and not mods & FORBIDDEN


def test_a_cpu_run_imports_no_jax():
    mods = top_level("import torch; torch.set_num_threads(2)\n"
                     "from perfbench.tests._tiny import tiny_cell\n"
                     "from perfbench.run import run_cell\n"
                     "run_cell(tiny_cell(), 3, 1.0, False, 'cpu')")
    assert "gemm_gan_tpu_torch" in mods
    assert not mods & FORBIDDEN
