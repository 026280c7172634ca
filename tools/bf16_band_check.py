#!/usr/bin/env python3
"""The bf16 inner transport operator on the synthetic crossbar: one cold
transport solve from the same state with each form of the inner operator.

    JAX_PLATFORMS=cpu python3 tools/bf16_band_check.py [--n-sites 5000] [--jax]
    python3 tools/bf16_band_check.py --device cuda --n-sites 110000 --cc fly

Builds ``chip_smoke.synthetic_crossbar``'s structure and transport settings
(``--cc stored``: the stored metal block, so that the bf16 twin products run
too; ``fly``: the on-the-fly kernels, as the smoke run's transport path),
runs the cold CB-edge and boundary solves at 1 V, and then the cold
(deflated) transport solve with: the f32 band at tolerances 1e-8, 1e-9 and
1e-10; ``transport_bf16_inner`` (bf16 band, f32 vector, each row's rounding
on the diagonal: ``row_fix``) at 1e-8 and at its default 1e-10 after the
option's tightening; the same without ``row_fix``.  ``--jax`` adds the JAX
package's own bf16 solve on the CPU (its band's rows rounded against the
exact diagonal, the vector rounded to bf16).  Prints each solve's
iterations, whether it converged, its seconds and its I_macro, against the
dense direct solve where the device is the CPU; on the card also its name
and power limit.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def jax_solve(n_sites, maxiter):
    import jax

    jax.config.update("jax_enable_x64", True)
    from devicekmc_tpu.config import KMCConfig
    from devicekmc_tpu.physics import charge as jch
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu.physics import potential as jpot
    from devicekmc_tpu.state import (
        build_geometry, build_params, init_state, make_substoichiometric,
    )
    from devicekmc_tpu.structure import make_crossbar_structure

    nxc, nxo, f = 10, 24, 0.74
    ny = nz = max(8, int(round((n_sites / (2 * nxc + nxo * (1 + f))) ** 0.5)))
    s = make_crossbar_structure(nx_contact=nxc, nx_oxide=nxo, ny=ny, nz=nz, seed=1)
    elems = make_substoichiometric(s.elements, 0.02, seed=5)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.5, pbc=False, site_order="x",
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact, num_atoms_contact=s.num_atoms_contact,
        layers=s.layers, solve_potential=True, solve_current=True, perturb_structure=True,
        precision="mixed", poisson_compact_cap=8192, solver_tol=1e-8, transport="blocked",
        transport_precond="deflated", coarse_slabs=24, tunnel_vac_cap=256,
        tunnel_int_steps=256, transport_bf16_inner=True)
    g = build_geometry(elems, s.coords, cfg)
    p = build_params(cfg)
    st = init_state(g, cfg, elems)
    st, _ = jch.update_charge(g, st)
    cold = p.replace(boundary_precond="deflated")
    st, _ = jpot.solve_cb_edge(g, cold, st, 1.0)
    st, _ = jpot.solve_boundary_potential(g, cold, st, 1.0)
    I_ref = float(jcur.update_power(g, p, st, 1.0, method="direct")[0].I_macro)
    band = jcur.build_banded_nb(g, p, st)
    t0 = time.perf_counter()
    s2, m = jcur.update_power_blocked(g, p, st, 1.0, cc={"band": band}, cg_maxiter=maxiter)
    report("JAX package, bf16 band, tolerance 1e-10", int(s.elements.shape[0]),
           int(m["cg_iters_power"]), bool(m["transport_converged"]),
           time.perf_counter() - t0, float(s2.I_macro), I_ref)


def port_solves(n_sites, maxiter, device, cc):
    import torch

    import chip_smoke
    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.physics import current as cur

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    sim = chip_smoke.synthetic_crossbar(n_sites, device, tempfile.mkdtemp(), current=True,
                                        transport_bf16_inner=True, transport_cc=cc)
    g, p = sim.geom, sim.params
    cold = dataclasses.replace(p, boundary_precond="deflated")
    sim.state, _ = engine._phase_cb_edge(g, cold, sim.state, 1.0)
    sim._chunked_boundary(1.0, 200, cold)
    st = sim.state
    cache = cur.assemble_transport_cache(g, p, st)
    I_ref = (cur.update_power(g, p, st, 1.0, method="direct")[0].I_macro
             if device == "cpu" else None)
    f32 = dataclasses.replace(p, transport_bf16_inner=False)
    f32_band = cur.build_banded_nb(g, f32, st)
    no_fix = {k: v for k, v in sim._band.items() if k != "row_fix"}
    # cg_tol: the stopping tolerance before the bf16 option's 1e-2 tightening
    for name, pp, band, tol in (
            ("f32 band, tolerance 1e-8", f32, f32_band, 1e-8),
            ("f32 band, tolerance 1e-9", f32, f32_band, 1e-9),
            ("f32 band, tolerance 1e-10", f32, f32_band, 1e-10),
            ("bf16 band with row_fix, tolerance 1e-8", p, sim._band, 1e-6),
            ("bf16 band with row_fix, tolerance 1e-10 (the default)", p, sim._band, 1e-8),
            ("bf16 band without row_fix, tolerance 1e-8", p, no_fix, 1e-6)):
        sync()
        t0 = time.perf_counter()
        s2, m = cur.update_power(g, pp, st, 1.0, cc=dict(cache, band=band), cg_tol=tol,
                                 cg_maxiter=maxiter)
        sync()
        report(f"port ({device}, metal block {cc}), {name}", g.N, int(m["cg_iters_power"]),
               bool(m["transport_converged"]), time.perf_counter() - t0, s2.I_macro, I_ref)


def report(name, n, iters, converged, seconds, I, I_ref):
    ref = "" if I_ref is None else \
        f", {I / I_ref - 1:+.3e} from the direct solve ({I_ref:.6e} A)"
    print(f"{name} ({n} sites): {iters} iterations, converged {converged}, "
          f"{seconds:.2f} s, I_macro {I:.9e} A{ref}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-sites", type=int, default=5000)
    ap.add_argument("--maxiter", type=int, default=20000)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--cc", choices=("stored", "fly"), default="stored")
    ap.add_argument("--jax", action="store_true",
                    help="also the JAX package's bf16 solve (CPU)")
    args = ap.parse_args()
    import torch

    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    else:
        torch.set_num_threads(4)
    port_solves(args.n_sites, args.maxiter, args.device, args.cc)
    if args.jax:
        jax_solve(args.n_sites, args.maxiter)


if __name__ == "__main__":
    main()
