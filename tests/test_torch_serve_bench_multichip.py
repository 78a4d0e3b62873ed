"""``python -m distkeras_torch.serve_bench --multichip`` on the CPU: the
reference's tensor-parallel decode bench (``bench_multichip``) at its
smoke sizes, tp 1 and 2, the tp=2 engine as two spawned gloo ranks under
the engine's lock-step loop. The smoke asserts parity: every stream
equal to the mesh-less engine's token for token, and each follower's
kept streams and ticks equal to the leader's. A rank made to drop one
admission fails the smoke, naming the rank that fell out of lock step.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_spawn_util import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a rank's launcher: rank 1's scheduler drops the third admission its
# step records carry
_DROPPING = '''
import runpy
import sys

from distkeras_torch.serving import scheduler

real = scheduler.FIFOScheduler.submit
seen = [0]


def dropping(self, req):
    seen[0] += 1
    if sys.argv[-1] == "1" and seen[0] == 3:
        return req
    return real(self, req)


scheduler.FIFOScheduler.submit = dropping
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def test_multichip_smoke_holds_parity():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "distkeras_torch.serve_bench",
         "--multichip", "--smoke", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads([ln for ln in out.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert res["parity"] and res["follower_parity"]
    assert res["tp_backend"] == {"tp1": None, "tp2": "gloo"}
    assert set(res["multichip_decode_tok_s"]) == {"tp1", "tp2"}
    assert res["config"].endswith("-smoke")


def test_a_rank_that_drops_an_admission_fails_the_smoke(tmp_path):
    from distkeras_torch.serve_bench import bench_multichip

    launcher = tmp_path / "dropping_launch.py"
    launcher.write_text(_DROPPING)
    with pytest.raises(AssertionError,
                       match=r"(?s)multichip tp=2: rank 1 failed.*tp rank 1 "
                             r"fell out of lock step"):
        bench_multichip(tp_list=(2,), smoke=True, device="cpu",
                        python=[sys.executable, str(launcher)],
                        timeout_s=120)
