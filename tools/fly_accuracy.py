#!/usr/bin/env python3
"""How accurate the on-the-fly WKB kernels are: their results against an
f64 evaluation, beside the plain f32 version's.

    python3 tools/fly_accuracy.py

Needs one NVIDIA card and nvcc.  Builds the synthetic crossbar of
``chip_smoke.py`` with transport on, runs the cold solves for the CB edges,
and takes two sets of metal atoms: the transport path's own (n_mp = 3,527)
and 24,768 of the structure's metal atoms (the reference crossbar's count),
the second also with its CB edges permuted over the atoms (what the kernels
cost when no chunk of columns can be skipped).
On each, y = T x and Y = T X (K = 24) are evaluated in f64 with PyTorch (the
plain version's formula on f64 tensors) and compared with the plain f32
version (``wkb_fly_matmat_plain``) and with the kernels (approximate square
roots and reciprocal in the value, expf), each as max |difference| over
max |f64 result|; the kernels are also held against the plain version (the
port's tolerance is 1e-5 there) and timed with CUDA events.  Prints the
card's name and power limit.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def pair_vals_f64(env, pr, cr, pc, cc):
    """``ops.wkb_fly.pair_vals_plain`` on f64 tensors."""
    import torch

    d = pr[:, None, :] - pc[None, :, :]
    if env["pbc"]:
        for a in (1, 2):
            L = env["lattice"][a]
            d[..., a] -= torch.round(d[..., a] / L) * L
    dist = d.pow(2).sum(-1).sqrt()
    abs_dE = (cr[:, None] - cc[None, :]).abs()
    elig = (abs_dE > env["ctol"]) & ~(dist < env["nn"])
    safe = torch.where(elig, abs_dE, 1.0)
    s = env["prefac"] * (dist * 1e-10) / safe
    E2 = env["qV0"] - safe
    E2p = E2.clamp(min=0)
    T = torch.where(E2 != 0, torch.exp(s * (env["qV0"] ** 1.5 - E2p ** 1.5)), 0.0)
    return torch.where(elig, -T, 0.0)


def matmat_f64(env, pos, cb, X):
    import torch

    p, c, X = pos.double(), cb.double(), X.double()
    out = torch.empty_like(X)
    for r0 in range(0, p.shape[0], 1024):
        out[r0:r0 + 1024] = pair_vals_f64(env, p[r0:r0 + 1024], c[r0:r0 + 1024], p, c) @ X
    return out


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def metal_sets():
    """(env, {tag: (pos, cb)}): the transport path's metal atoms and CB edges
    on the synthetic crossbar, and 24,768 of its metal atoms."""
    import chip_smoke as cs
    from devicekmc_tpu_torch.physics import current as cur

    sim = cs.synthetic_crossbar(cs.N_SITES, "cuda",
                                os.path.join(ROOT, "build", "fly_accuracy"), current=True)
    sim.run_bias_point(cs.VD_MAIN, 1e30, max_steps=1)
    blk = cur.assemble_X_blocks(sim.geom, sim.params, sim.state, band=sim._band)
    return blk["fly"]["env"], {
        "n_mp=3527": (blk["fly"]["mpos"], blk["fly"]["mcb"]),
        f"n_mp={cs.REF_N_MP}": cs.reference_metal_set(sim)}


def main():
    import torch

    import chip_smoke as cs
    from devicekmc_tpu_torch.ops import wkb_fly as w

    if not torch.cuda.is_available():
        print("fly_accuracy: no CUDA device", file=sys.stderr)
        return 2
    print(cs.gpu_line())
    env, sets = metal_sets()
    # the same atoms with their CB edges dealt out at random: as many pairs
    # pass the CB-edge test, but no chunk of 32 columns is left to skip
    rpos, rcb = sets[f"n_mp={cs.REF_N_MP}"]
    perm = torch.randperm(rcb.shape[0], device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    sets[f"n_mp={cs.REF_N_MP}, CB edges permuted"] = (rpos, rcb[perm].contiguous())
    for tag, (pos, cb) in sets.items():
        n = pos.shape[0]
        g = torch.Generator(device="cuda").manual_seed(n)
        X = torch.randn((n, 25), generator=g, device="cuda")
        t64 = matmat_f64(env, pos, cb, X)
        plain = w.wkb_fly_matmat_plain(pos, cb, X, env)
        x, X = X[:, 0].contiguous(), X[:, 1:].contiguous()
        skipped = float(w.chunk_skip_plain(cb, cb, env["ctol"]).float().mean())
        ys = w.wkb_fly_matvec(pos, cb, x, env, symmetric=True)
        yr = w.wkb_fly_matvec(pos, cb, x, env, symmetric=False)
        Y = w.wkb_fly_matmat(pos, cb, X, env)
        print(f"{tag}: {100 * skipped:.2f} % of the 32 x 32 chunks skipped; against f64: "
              f"plain f32 version matvec {rel(plain[:, 0], t64[:, 0]):.3e}, matmat "
              f"{rel(plain[:, 1:], t64[:, 1:]):.3e}; kernels symmetric "
              f"{rel(ys, t64[:, 0]):.3e}, row form {rel(yr, t64[:, 0]):.3e}, matmat "
              f"{rel(Y, t64[:, 1:]):.3e}; kernels against the plain version: "
              f"{rel(ys, plain[:, 0]):.3e}, {rel(yr, plain[:, 0]):.3e}, "
              f"{rel(Y, plain[:, 1:]):.3e}; ms: "
              f"{cs.time_ms(lambda: w.wkb_fly_matvec(pos, cb, x, env)):.4f}, "
              f"{cs.time_ms(lambda: w.wkb_fly_matvec(pos, cb, x, env, symmetric=False)):.4f}, "
              f"{cs.time_ms(lambda: w.wkb_fly_matmat(pos, cb, X, env)):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
