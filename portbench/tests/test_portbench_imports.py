"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or dbcsr_tpu (the name compared whole: dbcsr_tpu_torch is the program),
and nothing of the program in the reference."""

import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.tiny import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "dbcsr_tpu")


def _loaded_after(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_whole_name_comparison():
    assert harness.FORBIDDEN == FORBIDDEN
    assert "dbcsr_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "dbcsr_tpu.core".split(".")[0] in FORBIDDEN


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = (
        "import json\n"
        "from dbcsr_tpu_torch import device\n"
        "device.set_default_device('cpu')\n"
        "from portbench import harness\n"
        "from portbench.tests import tiny\n"
        f"pb, bench = tiny.add_cells({str(tmp_path)!r})\n"
        "for cell in sorted(tiny.CELLS):\n"
        "    for trace in (False, True):\n"
        "        out = harness.run_cell(cell, 3, 0.2, trace, 'cpu', bench, 0.0, pb_dir=pb)\n"
        "        assert out['correct'], out\n"
        "import portbench.control, portbench.tracing\n"
    )
    loaded = _loaded_after(code)
    assert "dbcsr_tpu_torch" in loaded
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN]


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.blocksparse, portbench.inputs, "
                           "portbench.peaks, portbench.answers")
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN + ("dbcsr_tpu_torch",)]


def test_run_refuses_without_a_card():
    """No CUDA device visible: exit 2 and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ns_f64.scf",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 2 and out.stdout.strip() == ""
