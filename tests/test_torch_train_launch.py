"""The training launcher and the laned data-parallel step, on the CPU:
`repro_torch.launch.train.main` against `repro.launch.train.main` for
mamba2-130m `--smoke` over 4 steps with the same flags (both start from
`prng_key(0)`'s weights; per-step losses within 1e-2 relative in bf16
compute, the lane controller's printed decisions equal); a checkpoint at
step 2 resumed gives steps 2-3 bit for bit as the uninterrupted run; and
`make_laned_train_step` in a 2-process gloo group at lane widths 1, 2 and
4 (float32 compute), whose parameters must agree bit for bit and match the
one-process step on the whole batch at 1e-5 relative RMS, the loss at
1e-6.
"""
import contextlib
import io
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_train_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FLAGS = ["--arch", "mamba2-130m", "--smoke", "--steps", "4", "--batch", "4",
         "--seq", "64", "--log-every", "1", "--epoch-steps", "2"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = main(argv)
    return losses, out.getvalue()


def test_launcher_matches_the_reference():
    from repro.launch.train import main as jmain
    from repro_torch.launch.train import main as tmain

    want, jlog = _run(jmain, FLAGS)
    got, tlog = _run(tmain, FLAGS + ["--device", "cpu"])
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-2)
    lanes = re.compile(r"\[lanes\].*")
    assert lanes.findall(tlog) == lanes.findall(jlog)
    assert "[train] final loss" in tlog


def test_resume_from_a_checkpoint_is_bitwise(tmp_path):
    from repro_torch.launch.train import main as tmain

    base = FLAGS + ["--device", "cpu"]
    full, _ = _run(tmain, base)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first, _ = _run(tmain, [*base[:base.index("--steps") + 1], "2",
                            *base[base.index("--steps") + 2:], *ck])
    rest, log = _run(tmain, base + ck + ["--resume"])
    assert "[train] resumed from step 2" in log
    assert first == full[:2] and rest == full[2:]


_CHILD = r"""
import sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import get_model, layers
from repro_torch.random import prng_key
from repro_torch.train.laned_sync import compile_lane_variants
from repro_torch.train.train_step import init_train_state, make_train_step
layers.COMPUTE_DTYPE = torch.float32
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
model = get_model(get_smoke_config("stablelm-3b"))
batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
    model.cfg, DataConfig(global_batch=8, seq_len=32)).host_slice(0).items()}
kw = {"total_steps": 10, "lr": 1e-2, "warmup": 1}
steps = compile_lane_variants(model, dist.group.WORLD, None, None, kw)
assert sorted(steps) == [1, 2, 4]
out = {}
for lanes in (1, 2, 4):
    state = init_train_state(model, prng_key(0, device="cpu"))
    for _ in range(2):
        state, metrics = steps[lanes](state, batch)
    out[lanes] = (float(metrics["loss"]),
                  torch.cat([p.reshape(-1) for p in
                             [state["params"]["ln_f"]["scale"],
                              state["params"]["layers"]["attn"]["wq"],
                              state["params"]["embed"]["embedding"]]]))
same = all(torch.equal(out[w][1], out[1][1]) and out[w][0] == out[1][0]
           for w in (2, 4))
one = init_train_state(model, prng_key(0, device="cpu"))
step = make_train_step(model, opt_overrides=kw, guard=False)
for _ in range(2):
    one, m1 = step(one, batch)
ref = torch.cat([p.reshape(-1) for p in [one["params"]["ln_f"]["scale"],
                 one["params"]["layers"]["attn"]["wq"],
                 one["params"]["embed"]["embedding"]]])
rel = float((out[1][1] - ref).norm() / ref.norm())
dist.destroy_process_group()
print("RESULT", same, rel, abs(out[1][0] - float(m1["loss"])))
"""


def test_laned_steps_agree_across_widths_over_two_gloo_ranks():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r), port],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        line = next(x for x in out.splitlines() if x.startswith("RESULT"))
        _, same, rel, dloss = line.split()
        assert same == "True", out
        assert float(rel) <= 1e-5 and float(dloss) <= 1e-6, line


@pytest.mark.parametrize("lanes", [1, 4])
def test_laned_step_without_a_group_is_the_plain_step(lanes):
    """group=None is a group of one: the laned step equals
    `make_train_step(guard=False)` bit for bit."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import get_model
    from repro_torch.random import prng_key
    from repro_torch.train.laned_sync import make_laned_train_step
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    from torch_train_parity import keyed_torch

    model = get_model(get_smoke_config("mamba2-130m"))
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        model.cfg, DataConfig(global_batch=4, seq_len=32)).host_slice(1)
        .items()}
    a = init_train_state(model, prng_key(0, device="cpu"))
    b = init_train_state(model, prng_key(0, device="cpu"))
    a, ma = make_laned_train_step(model, None, lanes)(a, batch)
    b, mb = make_train_step(model, guard=False)(b, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for k, v in keyed_torch(b).items():
        np.testing.assert_array_equal(keyed_torch(a)[k], v, err_msg=k)
