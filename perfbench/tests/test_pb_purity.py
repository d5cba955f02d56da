"""What a run of each cell loads: no module whose top-level name is JAX's or
the JAX package's (compared whole: the program `cspn_tpu_torch` begins with
`cspn_tpu`), and the harness refuses a run that holds one."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import cell as cells
from perfbench.harness import env

WORKLOADS = [w["name"] for w in json.loads((cells.ROOT / "BENCHMARK.json").read_text())["workloads"]]

RUN = """
import json, sys
from perfbench.tests import pb_helpers
from perfbench.harness import env
pb_helpers.run_line(pb_helpers.tiny({name!r}, size=(36, 52), steps=4), seconds=2.0, trace=True)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("name", WORKLOADS)
def test_a_run_loads_nothing_of_jax(name):
    out = subprocess.run([sys.executable, "-c", RUN.format(name=name)], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "cspn_tpu_torch" in loaded
    assert env.forbidden_modules(loaded) == []


def test_forbidden_names_are_compared_whole():
    assert env.forbidden_modules(["cspn_tpu_torch.serving", "jaxtyping", "flaxx"]) == []
    assert env.forbidden_modules(["jax.numpy", "cspn_tpu.ops", "torch"]) == ["cspn_tpu", "jax"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.unet, perfbench.reference.layers; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "cspn_tpu_torch" not in out.stdout and "jax" not in out.stdout
