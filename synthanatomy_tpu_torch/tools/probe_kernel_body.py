"""Probe: where does the time of the training kernels' bodies go?

Port of ``tools/probe_kernel_body.py``, with its flags, shapes, rows,
labels, projection and seeds.  At the paper shape (B6 x 8 local + 8
FAVOR heads of d 64, L 1401, w 420, m 256, chunk 128, bf16) it times:

1. the banded local-attention forward under body ablations
   (``ops/kernel_body.local_fwd_body``: full, matmuls only, deferred
   normalisation, deferred + scale folded into q, no row max) and with
   several heads per block, the port's counterpart of the TPU kernel's
   batch·head tile ``bt``;
2. the local backward (full or matmuls only; heads per block; f32 or
   bf16 outputs);
3. the FAVOR+ forward, dq and dk/dv sweeps (full, identity features,
   no causal select).

Each row launches its kernel ``--reps`` times between CUDA events and
reports the minimum of 5 such measurements, as the TPU probe's
``timed`` does.  The port launches each FAVOR backward sweep on its
own (the backward's state and scan launches, then the sweep's
consumer), so the dq and dk/dv rows print the sweep alone and the sum
with the forward, which is what the TPU probe's rows measure.  Before
timing, every variant is held against its plain twin at a small shape,
in bf16 and f32 (identity features with positive q, k and projection,
so that their denominator stays positive); the production-equal
bodies (local forward ``foldscale``, local backward ``full``, FAVOR
``full``) against the production kernels bit for bit at the paper
shape; and each timed variant's first launch against its plain twin at
the paper shape (identity features excepted: with the probe's
projection their denominator crosses zero).  A failed check raises; a
variant whose shared memory exceeds the card's per-block limit prints
``does not fit: <bytes>``.

    python -m synthanatomy_tpu_torch.tools.probe_kernel_body [--reps 50] [--quick]
    python -m synthanatomy_tpu_torch.tools.probe_kernel_body --cpu --reps 1

``main`` returns what it printed as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from synthanatomy_tpu_torch.ops import kernel_body as kb
from synthanatomy_tpu_torch.tools._probe_util import device_name, elapsed_s, probe_device

# the paper shape (the TPU probe's :51-54)
B, H, L, D = 6, 8, 1401, 64  # 8 local + 8 FAVOR heads of the 16
W = 420
M_FEAT = 256
CHUNK = 128
# the checks' small shape: L not a multiple of the 64-row tile or the
# chunk, B·H not a multiple of the heads per block
SMALL, SMALL_W, SMALL_M, SMALL_CHUNK, SMALL_HPB = (2, 3, 300, 64), 100, 64, 128, 4
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

LOCAL_FWD_ROWS = [  # label (the TPU probe's), body, heads per block
    ("full body", "full", 1),
    ("matmuls only (no softmax)", "matmuls", 1),
    ("defer normalization past PV", "defer", 1),
    ("defer + fold scale into q", "foldscale", 1),
    ("no rowmax stabilizer", "nomax", 1),
    ("full, bt=4", "full", 4),
    ("full, bt=6 (budget 2x)", "full", 6),
    ("defer+foldscale, bt=4", "foldscale", 4),
    ("defer+foldscale, bt=6", "foldscale", 6),
    ("defer+foldscale, bt=8", "foldscale", 8),
]
LOCAL_BWD_ROWS = [  # label, body, heads per block, f32 outputs
    ("full body, bt=1 (current default)", "full", 1, True),
    ("matmuls only (no softmax chain)", "matmuls", 1, True),
    ("full, bt=2 (budget bump)", "full", 2, True),
    ("full, bf16 outputs, bt=1", "full", 1, False),
    ("full, bf16 outputs, bt=2", "full", 2, False),
    ("full, bf16 outputs, bt=4", "full", 4, False),
]
FAVOR_ROWS = [  # label, which, body
    ("fwd full", "fwd", "full"),
    ("fwd identity features (no exp chain)", "fwd", "idfeat"),
    ("fwd no causal mask select", "fwd", "nomask"),
    ("dq full (fwd+dq measured; subtract fwd)", "dq", "full"),
    ("dkv full (fwd+dkv measured; subtract fwd)", "dkv", "full"),
    ("dkv identity features", "dkv", "idfeat"),
]


def compare(name, got, want, tol, bound=None):
    """Kernel against plain twin on the same inputs: max abs error at
    most ``tol`` of the plain result's largest magnitude and
    norm-relative error at most ``tol`` / 2 (``TOL``: bf16: both round at
    the same points and sum in other orders, so an operand on a rounding
    boundary may go the other way (2^-8 of it) and move what it feeds by
    up to ~1e-2 of the largest; f32: ~1e-6).  A wrong mask, body or
    index gives errors of order 1.  With ``bound`` (per element, from
    :func:`idfeat_dq_bound`), the error beyond it is held to that.
    Raises on a failure; returns the max abs error (beyond the bound)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if bound is not None:
        diff = (diff - bound.float()).clamp(min=0)
    err = float(diff.max())
    if not (err <= tol * float(want.abs().max())
            and float(torch.linalg.norm(diff)) <= tol / 2 * float(torch.linalg.norm(want))):
        raise RuntimeError(f"probe_kernel_body: {name} disagrees with its plain twin: max abs "
                           f"err {err:.3e}{' beyond the bound' if bound is not None else ''}, "
                           f"max |plain| {float(want.abs().max()):.3e}")
    return err


def _inputs(shape, dtype, seed, dev, positive=False):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape) * 0.5 for _ in range(4)]
    if positive:
        xs[0], xs[1] = np.abs(xs[0]), np.abs(xs[1])
    return [torch.from_numpy(x.astype(np.float32)).to(dtype).to(dev) for x in xs]


def _favor_inputs(body, dtype, dev, small=None):
    """q, k, v, g and a projection at ``small`` (default ``SMALL``): for
    identity features positive q, k and projection (their denominator
    then stays positive), else a Gaussian projection."""
    small = small or SMALL
    pos = body == "idfeat"
    q, k, v, g = _inputs(small, dtype, 2, dev, positive=pos)
    rng = np.random.default_rng(3)
    shape = (SMALL_M, small[-1])
    proj = rng.uniform(0.0, 0.1, size=shape) if pos else rng.normal(size=shape)
    return q, k, v, g, torch.from_numpy(proj.astype(np.float32)).to(dev)


def check_small(dev) -> float:
    """Every variant against its plain twin at the small shape, bf16 and
    f32; returns the largest error relative to the plain magnitude."""
    worst = 0.0

    def note(name, got, want, dtype, tol=None, bound=None):
        nonlocal worst
        err = compare(name, got, want, tol or TOL[dtype], bound)
        worst = max(worst, err / max(float(want.float().abs().max()), 1e-30))

    hpbs = sorted({1, SMALL_HPB})
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g = _inputs(SMALL, dtype, 1, dev)
        for body in kb.LOCAL_FWD_BODIES:
            want = kb.local_fwd_body_plain(q, k, v, SMALL_W, body)
            for hpb in hpbs:
                note(f"local fwd {body} hpb {hpb}", kb.local_fwd_body(q, k, v, SMALL_W, body, hpb),
                     want, dtype)
        for body in kb.LOCAL_BWD_BODIES:
            want = kb.local_bwd_body_plain(q, k, v, g, SMALL_W, body, True)
            for hpb in hpbs:
                for out_f32 in (True, False):
                    got = kb.local_bwd_body(q, k, v, g, SMALL_W, body, hpb, out_f32)
                    for n, a, b in zip(("dq", "dk", "dv"), got, want):
                        note(f"local bwd {body} hpb {hpb} {n}", a, b, dtype)
        for body in kb.FAVOR_BODIES:
            q, k, v, g, proj = _favor_inputs(body, dtype, dev)
            out, den = kb.favor_fwd_body(q, k, v, proj, SMALL_CHUNK, body)
            want = kb.favor_fwd_body_plain(q, k, v, proj, SMALL_CHUNK, body)
            note(f"favor fwd {body} out", out, want[0], dtype)
            note(f"favor fwd {body} den", den, want[1], dtype)
            for sweep in kb.FAVOR_SWEEPS:
                got = kb.favor_bwd_body(q, k, v, proj, g, out, den, SMALL_CHUNK, body, sweep)
                want = kb.favor_bwd_body_plain(q, k, v, proj, g, out, den, SMALL_CHUNK, body,
                                               sweep)
                if sweep == "dq":
                    got, want = (got,), (want,)
                # identity features' dq = du·P·d^-1/4 − w·d^-1/2·q nearly
                # cancels: f32 sums in other orders reach ~2e-4 of it; in
                # bf16 a tensor-core sum may put ds on the other side of a
                # bf16 rounding boundary (dq_cancellation), which moves
                # its row by up to idfeat_dq_bound
                tol = 1e-3 if (body, sweep, dtype) == ("idfeat", "dq", torch.float32) else None
                bound = (idfeat_dq_bound(q, k, v, proj, g, out, den, SMALL_CHUNK)
                         if (body, sweep, dtype) == ("idfeat", "dq", torch.bfloat16) else None)
                for i, (a, b) in enumerate(zip(got, want)):
                    note(f"favor {sweep} {body} output {i}", a, b, dtype, tol, bound)
    return worst


# The tensor cores' sum of a k16 step misses the exactly rounded sum by
# at most ~1.0e-7 of the step's Σ|terms| on the card (dq_cancellation's
# readings); the bound below allows 2^-20 (9.5e-7) of a product's
# Σ|terms|: the kernel's 4 k16 steps and the plain twin's own f32 sum.
MMA_SUM_MISS = 2.0 ** -20


def rounded_bf16(x):
    return x.to(torch.bfloat16).float()


def _ulp_bf16(x):
    """The spacing of bf16 values at |x| (x of bf16 values, f32)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), (e - 8).clamp(min=-133))


def idfeat_dq_bound(q, k, v, proj, g, out, den, chunk):
    """Per element of the identity-features dq sweep (bf16), the largest
    move the card's sums can make in it through one bf16 rounding of ds
    = rnd(dnum)·vᵀ + gd: ds is a tensor-core sum (its miss at most
    ``MMA_SUM_MISS`` of Σ_e |rnd(dnum)_e·v_e| + |gd|), rounded to bf16 as
    the plain twin rounds it, so where ds lies that close to a rounding
    boundary rnd(ds) may go either way by one bf16 step Δ.  Each such
    (row i, key j) moves dq_p by Δ·kc_j, and through the plain twin's
    tail (w, the row max's share, rnd(du)·rnd(P)·dn − w·dn²·q) row i's
    dq by a vector whose magnitude is added, with one bf16 step of each
    du_f for the rounding of du.  The plain twin supplies every term;
    (B, H, L, d) f32, zero where no rounding of ds is that close."""
    shape = q.shape
    d, m = shape[-1], proj.shape[0]
    dn, r = np.float32(d ** -0.25), np.float32(m ** -0.5)
    pb = rounded_bf16(proj.float())
    qf, vf = kb.fa._flat(q).float(), kb.fa._flat(v).float()
    bound = torch.zeros_like(qf)
    for t in kb.favor_dq_terms(q, k, v, proj, g, out, den, chunk, "idfeat"):
        sl = t["sl"]
        c = t["kc"].shape[1]
        tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=q.device))
        sabs = rounded_bf16(t["dnum"]).abs() @ vf[:, sl].abs().transpose(1, 2) + t["gd"].abs()
        delta = torch.where(tri, MMA_SUM_MISS * sabs, 0.0)
        step = rounded_bf16(t["ds"] + delta) - rounded_bf16(t["ds"] - delta)
        for n, i, j in (step != 0).nonzero().tolist():
            dE = step[n, i, j] * t["kc"][n, j] * (r * t["e_q"][n, i])
            dw = dE.sum()
            ties = t["ties"][n, i]
            du = dE - ties * (dw / ties.sum())
            row = sl.start + i
            bound[n, row] += (dn * (du @ pb) - dw * (dn * dn) * qf[n, row]).abs() \
                + dn * (_ulp_bf16(rounded_bf16(t["du"][n, i])) @ pb.abs())
    return bound.view(shape)


def dq_cancellation(dev, small=(1, 2, 129, 32)) -> dict:
    """Where the bf16 identity-features dq sweep's kernel leaves its plain
    twin (``check_small``'s inputs at ``small``, m ``SMALL_M``, chunk
    ``SMALL_CHUNK``), rebuilt for the 16 rows of the worst element (the
    rows one warp of the kernel owns) from the plain twin's own operands
    in the kernel's order: dq_p = rnd(ds)·kc + rnd(dnum)·rnd(S)ᵀ + gd·z
    through ``mma_steps`` (the kernels' ``mma.sync``, each k16 step's
    accumulator read back, against exactly rounded steps), and ds =
    rnd(dnum)·vᵀ + gd through ``mma_steps`` too; the plain twin's tail
    turns each into dq.  Returns the readings (and prints them)."""
    bf = rounded_bf16
    q, k, v, g, proj = _favor_inputs("idfeat", torch.bfloat16, dev, small)
    out, den = kb.favor_fwd_body(q, k, v, proj, SMALL_CHUNK, "idfeat")
    got = kb.favor_bwd_body(q, k, v, proj, g, out, den, SMALL_CHUNK, "idfeat", "dq")
    want = kb.favor_bwd_body_plain(q, k, v, proj, g, out, den, SMALL_CHUNK, "idfeat", "dq")
    d, m, n = small[-1], proj.shape[0], small[2]
    got, want = got.reshape(-1, n, d).cpu(), want.reshape(-1, n, d).cpu()
    bh, i, e = (int(x) for x in np.unravel_index(int((got - want).abs().argmax()), got.shape))
    ci = i // SMALL_CHUNK
    t = {key: (val.cpu() if torch.is_tensor(val) else val) for key, val in
         kb.favor_dq_terms(q, k, v, proj, g, out, den, SMALL_CHUNK, "idfeat")[ci].items()}
    cl = t["kc"].shape[1]
    ir = i - ci * SMALL_CHUNK
    r0 = ir // 16 * 16  # the warp's 16 rows of the chunk
    rows = slice(r0, min(r0 + 16, cl))
    nr = rows.stop - rows.start
    keys = (ir // 64 + 1) * 64  # the key tiles the kernel walks (causal: up to its sub-tile)
    kk = min(cl, keys)  # the chunk's keys among them (the rest are zero)
    dp, mp = 64, -(-m // 64) * 64  # the kernel's padded head and feature widths

    def on_card(a, bt):
        """The card's accumulators after each k16 step of a (16, K) · bt (N,
        K)ᵀ, 8 columns at a time → (steps, 16, N)."""
        zero = torch.zeros(16, 8, device=dev)
        return torch.cat([kb.mma_steps(a.to(torch.bfloat16).to(dev),
                                       bt[c0:c0 + 8].to(torch.bfloat16).to(dev), zero).cpu()
                          for c0 in range(0, bt.shape[0], 8)], dim=-1)

    # dq_p's products: the chunk's key steps, then the head's
    a = torch.zeros(16, keys + dp)
    a[:nr, :kk] = bf(t["ds"][bh, rows, :kk])
    a[:nr, keys:keys + d] = bf(t["dnum"][bh, rows])
    bt = torch.zeros(mp, keys + dp)
    bt[:m, :kk] = t["kc"][bh, :kk].T
    bt[:m, keys:keys + d] = bf(t["S"][bh])
    steps = on_card(a, bt)
    card = steps[-1]
    exact = torch.cat([kb.mma_steps_exact(a.to(torch.bfloat16), bt[c0:c0 + 8].to(torch.bfloat16),
                                          torch.zeros(16, 8))[-1] for c0 in range(0, mp, 8)], -1)
    # each step against its exactly rounded sum from the card's own accumulator
    terms = a.double()[:, None, :] * bt.double()[None]  # (16, mp, K), each exact
    prev, miss_of_sum = torch.zeros(16, mp, dtype=torch.float64), 0.0
    for s_, acc in enumerate(steps):
        ts = terms[..., 16 * s_:16 * s_ + 16]
        miss = (acc.double() - (prev + ts.sum(-1)).float().double()).abs()
        total = ts.abs().sum(-1) + prev.abs()
        miss_of_sum = max(miss_of_sum, float((miss / total.clamp(min=1e-38)).max()))
        prev = acc.double()
    # ds of the 16 rows on the card (the head's k16 steps, then gd in f32),
    # and the keys whose bf16 rounding goes the other way than the plain's
    dnum_a = torch.zeros(16, dp)
    dnum_a[:nr, :d] = bf(t["dnum"][bh, rows])
    vk = torch.zeros(keys, dp)
    vk[:kk, :d] = kb.fa._flat(v).float().cpu()[bh, ci * SMALL_CHUNK:][:kk]
    ds_card = on_card(dnum_a, vk)[-1, :nr, :kk] + t["gd"][bh, rows]
    ds_card = torch.where(torch.tril(torch.ones(cl, cl, dtype=torch.bool))[rows, :kk], ds_card, 0.0)
    ds_plain = t["ds"][bh, rows, :kk]
    gz = t["gd"][bh, rows] * t["z"][bh][None]  # (nr, m), f32 products

    def to_dq(prod):
        """dq at the worst element from the rows' dq_p products (nr, m):
        the plain twin's tail."""
        dE = (prod[:nr, :m] + gz) * (m ** -0.5 * t["e_q"][bh, rows])
        w = dE.sum(-1, keepdim=True)
        ties = t["ties"][bh, rows]
        du = dE - ties * (w / ties.sum(-1, keepdim=True))
        dn = d ** -0.25
        qr = kb.fa._flat(q).float().cpu()[bh, ci * SMALL_CHUNK + r0:][:nr]
        return float((bf(du) @ bf(proj.float().cpu()) * dn - w * (dn * dn) * qr)[ir - r0, e])

    bound = idfeat_dq_bound(q, k, v, proj, g, out, den, SMALL_CHUNK).reshape(-1, n, d).cpu()
    res = {
        "worst": (bh, i, e), "kernel": float(got[bh, i, e]), "plain": float(want[bh, i, e]),
        "max_abs_plain": float(want.abs().max()),
        "ds_flips": [(ci * SMALL_CHUNK + r0 + a_, ci * SMALL_CHUNK + j, float(ds_plain[a_, j]),
                      float(ds_card[a_, j]))
                     for a_, j in (bf(ds_card) != bf(ds_plain)).nonzero().tolist()],
        "dq_from_card_mma": to_dq(card), "dq_from_exact_steps": to_dq(exact),
        "dq_from_plain_sum": to_dq(t["dqp"][bh, rows] - gz),
        "dq_from_card_ds": to_dq(bf(ds_card) @ t["kc"][bh, :kk]
                                 + bf(t["dnum"][bh, rows]) @ bf(t["S"][bh]).T),
        "step_miss_of_sum_abs_terms": miss_of_sum,
        "card_vs_exact_dqp_max": float((card - exact).abs().max()),
        "bound_at_worst": float(bound[bh, i, e]),
        "excess_over_bound_max": float(((got - want).abs() - bound).clamp(min=0).max()),
    }
    print("[dq cancellation] " + ", ".join(
        f"{key} {val:.9e}" if isinstance(val, float) else f"{key} {val}"
        for key, val in res.items()))
    return res


def check_production(q, k, v, g, proj) -> None:
    """The production-equal bodies against the production kernels, bit
    for bit (the same body, another instantiation)."""
    out, dq, dk, dv = kb.local_production(q, k, v, g, W)
    same = {"local fwd foldscale": torch.equal(kb.local_fwd_body(q, k, v, W, "foldscale"), out)}
    for out_f32 in (False, True):
        grads = kb.local_bwd_body(q, k, v, g, W, "full", 1, out_f32)
        same[f"local bwd full ({'f32 outputs, rounded' if out_f32 else 'bf16 outputs'})"] = all(
            torch.equal(a.to(q.dtype), b) for a, b in zip(grads, (dq, dk, dv)))
    f_out, f_den, f_dq, f_dk, f_dv = kb.favor_production(q, k, v, proj, g, CHUNK)
    out_v, den_v = kb.favor_fwd_body(q, k, v, proj, CHUNK, "full")
    same["favor fwd full"] = torch.equal(out_v, f_out) and torch.equal(den_v, f_den)
    same["favor dq full"] = torch.equal(
        kb.favor_bwd_body(q, k, v, proj, g, out_v, den_v, CHUNK, "full", "dq"), f_dq)
    dk_v, dv_v = kb.favor_bwd_body(q, k, v, proj, g, out_v, den_v, CHUNK, "full", "dkv")
    same["favor dkv full"] = torch.equal(dk_v, f_dk) and torch.equal(dv_v, f_dv)
    bad = [name for name, ok in same.items() if not ok]
    if bad:
        raise RuntimeError(f"probe_kernel_body: differs from the production kernel: {bad}")
    print(f"[check] equal to the production kernels bit for bit at the paper shape: "
          f"{', '.join(same)}")


def timed(fn, label, reps, dev, note="", n_meas=5):
    """Minimum (and median) over ``n_meas`` measurements of ``reps``
    launches between CUDA events (the host clock on the CPU)."""
    fn()  # warm
    ts = sorted(elapsed_s(lambda: [fn() for _ in range(reps)], dev) / reps
                for _ in range(n_meas))
    print(f"  {label:46s}: {ts[0] * 1e6:9.1f} us/invocation "
          f"(median {ts[len(ts) // 2] * 1e6:9.1f}){note}")
    return ts[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    args = ap.parse_args(argv)
    reps = args.reps
    dev = probe_device(args.cpu)

    print(f"device: {device_name(dev)}  paper shape: b{B} h{H} L{L} d{D} w{W} m{M_FEAT} "
          f"chunk{CHUNK}")
    res = {"small_check_rel_err": check_small(dev)}
    print(f"[check] every variant == its plain twin at {SMALL} (w {SMALL_W}, m {SMALL_M}, "
          f"chunk {SMALL_CHUNK}, 1 and {SMALL_HPB} heads per block), bf16 and f32: largest "
          f"error {res['small_check_rel_err']:.3e} of max |plain| (tol 2e-2 bf16, 1e-4 f32)")

    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy((rng.normal(size=(B, H, L, D)) * 0.5).astype(np.float32))
                  .to(torch.bfloat16).to(dev) for _ in range(4))
    proj = torch.full((M_FEAT, D), 0.05, dtype=torch.float32, device=dev)
    check_production(q, k, v, g, proj)
    bh, ntile = B * H, -(-L // 64)

    plain = {}

    def first_vs_plain(key, got, make_plain):
        """The row's first launch against its plain twin (cached per body)."""
        if key not in plain:
            plain[key] = make_plain()
        wants = plain[key] if isinstance(plain[key], tuple) else (plain[key],)
        gots = got if isinstance(got, tuple) else (got,)
        return max(compare(f"{key} at the paper shape", a, b, TOL[torch.bfloat16])
                   for a, b in zip(gots, wants))

    def row(table, label, note, launch, key, make_plain):
        """Time one row; its first launch is held against the plain twin."""
        try:
            err = None if make_plain is None else first_vs_plain(key, launch(), make_plain)
            table[label] = {"s": timed(launch, label, reps, dev, note), "err": err}
        except kb.DoesNotFit as e:
            print(f"  {label:46s}: does not fit: {e.nbytes} bytes")
            table[label] = {"s": None, "err": None, "does_not_fit": e.nbytes}
        return table[label]

    print(f"\n-- local attention forward (64-query tiles, two passes over the band's key "
          f"tiles, {ntile} x {bh} blocks at 1 head/block) --")
    res["local_fwd"] = {}
    for label, body, hpb in LOCAL_FWD_ROWS:
        row(res["local_fwd"], label, f"  [{body}, {hpb} head{'s' * (hpb > 1)}/block]",
            lambda body=body, hpb=hpb: kb.local_fwd_body(q, k, v, W, body, hpb),
            ("local fwd", body), lambda body=body: kb.local_fwd_body_plain(q, k, v, W, body))

    print(f"\n-- local attention backward (dq: 64-query tiles, two passes; dk/dv: 64-key "
          f"tiles over their 64-query tiles; 2 launches, 1 head/block) --")
    rows = LOCAL_BWD_ROWS[:3] if args.quick else LOCAL_BWD_ROWS
    res["local_bwd"] = {}
    for label, body, hpb, out_f32 in rows:
        row(res["local_bwd"], label,
            f"  [{body}, {hpb} head{'s' * (hpb > 1)}/block, {'f32' if out_f32 else 'bf16'} "
            f"outputs]",
            lambda body=body, hpb=hpb, o=out_f32: kb.local_bwd_body(q, k, v, g, W, body, hpb, o),
            ("local bwd", body),
            lambda body=body: kb.local_bwd_body_plain(q, k, v, g, W, body, True))

    blocks = bh * -(-L // CHUNK) * -(-CHUNK // 64)  # one per 64-row sub-tile of a chunk
    print(f"\n-- FAVOR kernels (chunk={CHUNK}, m={M_FEAT}, the chunk-parallel route: {blocks} "
          f"blocks a consumer and a forward state launch, {2 * blocks} a backward one; a "
          f"backward sweep alone also runs the backward's state and scan launches) --")
    rows = FAVOR_ROWS[:2] if args.quick else FAVOR_ROWS
    res["favor"] = {}
    fwd_res, fwd_s = {}, {}

    def fwd_of(body):
        if body not in fwd_res:
            fwd_res[body] = kb.favor_fwd_body(q, k, v, proj, CHUNK, body)
        return fwd_res[body]

    for label, which, body in rows:
        # with raw features the probe's denominator crosses zero: idfeat is
        # held against its plain twin at the small shape only
        held = body != "idfeat"
        if which == "fwd":
            entry = row(res["favor"], label, f"  [{body}]",
                        lambda body=body: kb.favor_fwd_body(q, k, v, proj, CHUNK, body),
                        ("favor fwd", body),
                        (lambda body=body: kb.favor_fwd_body_plain(q, k, v, proj, CHUNK, body))
                        if held else None)
            fwd_s[body] = entry["s"]
            continue
        entry = row(res["favor"], label, f"  [{body}: the {which} sweep alone]",
                    lambda body=body, which=which: kb.favor_bwd_body(
                        q, k, v, proj, g, *fwd_of(body), CHUNK, body, which),
                    (f"favor {which}", body),
                    (lambda body=body, which=which: kb.favor_bwd_body_plain(
                        q, k, v, proj, g, *fwd_of(body), CHUNK, body, which)) if held else None)
        if entry["s"] is None:
            continue
        if fwd_s.get(body) is None:  # the forward's time, for the TPU probe's sum
            fwd_s[body] = timed(lambda body=body: kb.favor_fwd_body(q, k, v, proj, CHUNK, body),
                                f"(fwd {body}, for the sum)", reps, dev)
        entry["with_fwd_s"] = entry["s"] + fwd_s[body]
        print(f"  {'':46s}  fwd + {which}: {entry['with_fwd_s'] * 1e6:9.1f} us (what the TPU "
              f"probe's row measures)")
    return res


if __name__ == "__main__":
    main()
