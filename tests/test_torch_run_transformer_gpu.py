"""The port's stage-2 CLI on the card at a small width with both attention
kernels on: two epochs of training launch row 5 (FAVOR+, 7 launches a
layer a step) and row 6 (local attention, 3) on every step, a second call
resumes from ``checkpoint_epoch=2``, and greedy ``--mode=inference``
takes the fused sampler (row 1, one step launch a token).  Its grids are
held against a ``--device=cpu`` run from the same checkpoint: equal, or
parting first where the two tokens' logits lie within ``NEAR_TIE``
(teacher-forced through the fused step's plain version).

Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_run_transformer_gpu.py

Every test is marked ``gpu`` and skips without a CUDA card.
"""

import os

import numpy as np
import pytest
import torch

from synthanatomy_tpu_torch.config import TransformerConfig
from synthanatomy_tpu_torch.models.sampling import fused_logits_stepper
from synthanatomy_tpu_torch.ops import favor_attention as fa
from synthanatomy_tpu_torch.ops import fused_decode as fd
from synthanatomy_tpu_torch.ops import local_attention_flash as lf
from synthanatomy_tpu_torch.run_transformer import run
from synthanatomy_tpu_torch.runners import transformer as runner
from synthanatomy_tpu_torch.train import checkpoints as C

pytestmark = pytest.mark.gpu

GRID = (6, 6, 6)
SEQ = 216
FLAGS = dict(
    experiment_name="gpu", batch_size=4, eval_batch_size=4, checkpoint_every=1, log_every=1,
    num_workers=2, vocab_size=64, n_embd=128, n_layers=2, n_head=2, dim_head=64,
    local_attn_heads=1, local_window_size=32, nb_features=64, use_rezero=True,
    spatial_position_emb="absolute", gamma=0.999, learning_rate=1e-3,
)
# the fused step runs int8 weights and bf16 FAVOR state on both sides;
# kernel and plain version sum in other orders, so greedy grids may part
# where two tokens' logits lie this close
NEAR_TIE = 0.05


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tmp_path_factory.mktemp("gpu_prior")
    rng = np.random.default_rng(0)
    for name, n in (("train", 8), ("sample", 4)):
        (root / name).mkdir()
        for i in range(n):
            # a structured grid with noise, so that training has something to learn
            grid = (np.arange(SEQ).reshape(GRID) * 3 + i) % 64
            grid = np.where(rng.random(GRID) < 0.1, rng.integers(0, 64, GRID), grid)
            np.save(root / name / f"s{i}_quantization_0.npy", grid.astype(np.uint16))
    return root


def _launches_per_step():
    proj = torch.empty(64, 64, device="cuda")
    q = torch.empty(1, 1, 1, 64, dtype=torch.bfloat16, device="cuda")
    return FLAGS["n_layers"] * fa.launches_per_call(q, proj, 128), FLAGS["n_layers"] * 3


def test_training_and_resume_launch_rows_5_and_6(data):
    proj = str(data / "proj")
    favor, local = _launches_per_step()
    for epochs, steps in ((2, 4), (3, 2)):
        fa.favor_attention_fused.launches = lf.local_attention_flash.launches = 0
        out = run(training_subjects=str(data / "train"), project_directory=proj,
                  epochs=epochs, **FLAGS)
        assert fa.favor_attention_fused.launches == steps * favor
        assert lf.local_attention_flash.launches == steps * local
        assert len(out["history"]) == steps // 2 and out["state"].step == 2 * epochs
        assert all(np.isfinite(h["Loss"]) for h in out["history"])
    ckdir = out["dirs"]["checkpoint_directory"]
    assert {"checkpoint_epoch=3", "model_state_dict_epoch=3.pt"} <= set(os.listdir(ckdir))


def _cpu_model(ckpt):
    cfg = TransformerConfig(device="cpu", **{k: v for k, v in FLAGS.items()
                                             if k in TransformerConfig.__dataclass_fields__})
    ordering = runner.build_ordering(cfg, GRID)
    model = runner.build_performer(cfg, ordering, GRID, device="cpu")
    C.load_checkpoint(ckpt, runner.create_transformer_train_state(model, 0), models_only=True)
    return model.eval(), ordering


def test_greedy_fused_sampling_matches_the_cpu(data):
    proj = str(data / "proj")
    ckdir = os.path.join(proj, "gpu", "performer", "checkpoints")
    if "checkpoint_epoch=3" not in os.listdir(ckdir):
        pytest.skip("needs the training test's checkpoint")
    grids = {}
    for device in (0, "cpu"):
        fd.fused_decode_step.launches = 0
        out = run(mode="inference", training_subjects=str(data / "sample"), sample=False,
                  project_directory=proj, device=device, **FLAGS)
        if device == 0:
            assert fd.fused_decode_step.launches == SEQ  # one sampler call of B4
        grids[device] = {os.path.basename(p): np.load(p) for p in out["written"]}
    assert sorted(grids[0]) == sorted(grids["cpu"]) and len(grids[0]) == 4
    model, ordering = _cpu_model(os.path.join(ckdir, "checkpoint_epoch=3"))
    order = ordering.get_sequence_ordering()
    for name, card in grids[0].items():
        cpu = grids["cpu"][name]
        assert card.dtype == np.uint16 and card.shape == GRID and int(card.max()) < 64
        if np.array_equal(card, cpu):
            continue
        sc, sp = card.reshape(-1)[order], cpu.reshape(-1)[order]
        p = int(np.nonzero(sc != sp)[0][0])
        step = fused_logits_stepper(model, batch=1, ring_quant=True)
        tok = torch.tensor([64])
        with torch.no_grad():
            for t in range(p + 1):
                logits = step(tok, t)[0]
                tok = torch.tensor([int(sc[t])])
        gap = abs(float(logits[int(sc[p])] - logits[int(sp[p])]))
        assert gap <= NEAR_TIE, (name, p, gap)
