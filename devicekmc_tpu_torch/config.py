"""Simulation configuration.

Parses the reference's ``parameters.txt`` format (line-oriented ``key = value``
with ``//`` comments; reference: src/input_parser.cpp) into a typed
:class:`KMCConfig`, and owns the device *layer table* which the reference
hard-codes at compile time (src/structure_input.h:8-50).  Field names,
defaults and the accepted keys are those of ``devicekmc_tpu.config``, so one
parameter file means the same thing to both packages.

Deliberate differences from the reference parser:
  * keys are matched as whole tokens, not substrings,
  * ``verbose`` does not clobber ``log_to_file`` (input_parser.cpp:46-48),
  * explicit ``0.0`` values are accepted (input_parser.cpp:330-334 rejects
    them).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import List, Optional

from .constants import COULOMB_K, M_0


@dataclass
class Layer:
    """One device layer with zero-field activation energies [eV]
    (reference ``Layer`` struct, src/utils.h:63-72)."""

    type: str = "oxide"
    E_gen_0: float = 0.0
    E_rec_1: float = 0.0
    E_diff_2: float = 0.0
    E_diff_3: float = 0.0
    start_x: float = 0.0
    end_x: float = 0.0


def default_layers() -> List[Layer]:
    """The reference's TiN-HfO2/Ti-TiN stack (src/structure_input.h:10-50)."""
    return [
        Layer("contact", 0.0, 0.0, 0.0, 0.76, -22.0, 0.0),
        Layer("interface", 3.93, 0.0, 1.09, 0.76, 0.0, 3.0),
        Layer("oxide", 3.93, 0.0, 1.09, 0.76, 3.0, 48.1431),
        Layer("interface", 1.66, 0.0, 1.09, 0.76, 48.1431, 52.6431),
        Layer("contact", 1.73, 0.0, 0.0, 2.8, 52.6431, 90.0),
    ]


@dataclass
class KMCConfig:
    # random seeds
    rnd_seed: int = 1                      # substoichiometric init RNG
    rnd_seed_kmc: int = 1                  # KMC event RNG (threefry key seed)

    # restart
    restart: bool = False
    restart_xyz_file: str = ""

    # I/O
    log_freq: int = 1
    output_freq: int = 1
    log_to_file: bool = True
    verbose: bool = False
    output_dir: str = "."

    # structure
    atom_xyz_file: str = ""
    interstitial_xyz_file: str = ""
    pristine: bool = False
    initial_vacancy_concentration: float = 0.0
    lattice: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    freq: float = 10e13                    # attempt frequency [1/s]
    nn_dist: float = 3.5                   # neighbour cutoff [Angstrom]
    pbc: bool = False
    shift: bool = False
    shifts: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])

    # contact geometry
    num_atoms_first_layer: int = 0
    num_layers_contact: int = 0
    num_atoms_contact: int = 0
    num_atoms_reservoir: int = 0
    metals: List[str] = field(default_factory=lambda: ["Ti", "N"])

    # module toggles
    solve_potential: bool = False
    solve_current: bool = False
    solve_heating_global: bool = False
    solve_heating_local: bool = False
    perturb_structure: bool = False

    # biasing
    V_switch: List[float] = field(default_factory=list)    # [V]
    t_switch: List[float] = field(default_factory=list)    # [s]
    Icc: float = 1e30                      # compliance current [uA]
    Rs: float = 0.0                        # series resistance [Ohm]

    # potential solver
    G_coeff: float = 1.0
    sigma: float = 3.5e-10                 # gaussian broadening [m]
    epsilon: float = 23.0                  # relative permittivity [1]

    # current solver (tunneling)
    m_r: float = 0.85                      # relative effective mass [1]
    V0: float = 1.6                        # defect state energy [eV]
    alpha: List[float] = field(default_factory=lambda: [0.1])

    # temperature solver
    k_therm: float = 1.1                   # [W/mK]
    background_temp: float = 300.0         # [K]
    dissipation_constant: float = 1e-13    # global model [J/Ks]
    small_step: float = 1e-17              # [s]
    event_time: float = 0.0
    delta_t: float = 1e-13                 # local model step [s]
    delta: float = 1.0
    power_adjustment_term: float = 1.0
    L_char: float = 3.5e-10                # characteristic length [m]
    k_th_metal: float = 29.0               # [W/mK]
    k_th_non_vacancy: float = 0.5          # [W/mK]
    k_th_vacancies: float = 5.0            # [W/mK]
    c_p: float = 1.92                      # [J/K cm^3]
    t_ox: float = 52.6838e-10              # oxide thickness [m]
    A: float = 0.0                         # device area [m^2]

    # layer table (replaces the reference's compile-time structure_input.h)
    layers: List[Layer] = field(default_factory=default_layers)

    # --- framework extensions (not in the reference) ---
    precision: str = "f64"                 # "f64" | "f32" | "mixed" (f32 rate
                                           # table and Poisson sweep, f64 solves)
    solver_tol: float = 1e-12              # CG relative tolerance
    transport_tol: float = 1e-8            # transport CG tolerance, in the Jacobi-scaled
                                           # residual norm
    solver_maxiter: int = 50000            # CG iteration cap (reference warns at 50k)
    selection: str = "two_level"           # "two_level" | "flat" event selection
    event_mode: str = "incremental"        # "incremental" | "scan" residence-time loop
    heat_solver: str = "dense"             # local heat model: "dense" (precomputed
                                           # inverses, the reference's way) | "cg"
                                           # (matrix-free, CG per substep)
    max_events_per_superstep: int = 10000  # safety bound for the event loop
    poisson_compact_cap: int = -1          # -1 auto-bucket; >0 fixed compaction size
    active_rows_cap: int = -1              # event-source row compaction: -1 auto, 0 full table, >0 fixed
    tunnel_vac_cap: int = -1               # vacancy bucket of the tunnel blocks: -1 auto,
                                           # >0 fixed
    tunnel_int_steps: int = 1024           # energy-window integration trip count (exact
                                           # while >= 100 * max CB-edge spread [V]; grown
                                           # with a redo when a step needed more)
    site_order: str = "file"               # "file" | "x": stable x-sort of the internal
                                           # site order; I/O stays in file order through
                                           # Geometry.io_idx
    bc_pinned_width: str = "first_layer"   # boundary-potential Dirichlet width:
                                           # "first_layer" (reference GPU path) |
                                           # "full_contact" (reference CPU path)
    transport_precond: str = "deflated"    # cold transport solves: "jacobi" | "deflated"
                                           # (A-DEF2 in the Jacobi-scaled metric, x-slab
                                           # Galerkin coarse space)
    boundary_precond: str = "jacobi"       # in-superstep boundary solve: "jacobi" |
                                           # "deflated"; the bias-start cold solve is
                                           # always deflated
    boundary_incremental: bool = True      # certify warm boundary solves from the
                                           # exactly maintained residual of the
                                           # changed rows (same plain-r criterion)
    boundary_delta_cap: int = 256          # max changed neutral-vacancy sites tracked per
                                           # superstep (overflow -> full solve, still exact)
    coarse_slabs: int = 16                 # x-slab aggregates of the deflated solve
    transport_warm_precond: str = "jacobi" # in-superstep transport re-solves
    coarse_yz: int = 1                     # transverse refinement of the transport coarse
                                           # space: K_tot = coarse_slabs * coarse_yz^2
    solver_chunk_iters: int = 0            # >0: bias-start cold solves as restarted CG
                                           # segments of this many iterations
    transport: str = "dense"               # "blocked" (matrix-free: ELL neighbour part +
                                           # tunnel blocks over vacancies and interior
                                           # metals) | "dense" (the [N_atom+2]^2 matrix:
                                           # tests and small devices)
    poisson_kernel: str = "jnp"            # compacted-Poisson pair sweep: "jnp" (exact
                                           # erfc, plain torch) | "pallas" (A&S erfc,
                                           # the hand-written CUDA kernel on the card)
    transport_bf16_inner: bool = False     # mixed mode: bf16 twins of the stored tunnel
                                           # blocks and a bf16 band in the f32 inner
                                           # iterations, transport_tol tightened by 1e-2
                                           # (at crossbar width set transport_tol >= 1e-6:
                                           # 1e-10 after the tightening does not converge)
    transport_skip_unchanged: bool = True  # exact skip of the in-superstep transport solve
                                           # when (element, charge) at atom sites and Vd are
                                           # unchanged since the last converged solve
    ell_gather_kernel: str = "jnp"         # accepted ("jnp" | "pallas") so a parameters
                                           # file means the same in both packages, then
                                           # ignored: both values gather the same bits,
                                           # and the port always takes the CUDA kernel
                                           # on the card
    transport_band_kernel: str = "jnp"     # accepted ("jnp" | "pallas") and ignored like
                                           # ell_gather_kernel: both compute the same
                                           # product, and the port always takes the banded
                                           # CUDA kernel on the card
    transport_cc: str = "auto"             # metal_p x metal_p tunnel block: "stored"
                                           # (materialised f32, cached per bias point),
                                           # "fly" (re-derived inside the on-the-fly CUDA
                                           # kernels in every product, never stored),
                                           # "auto" (stored below 3 GiB, fly beyond)
    tunnel_vm_kernel: str = "jnp"          # accepted ("jnp" | "pallas") and ignored: f32
                                           # vacancy x metal blocks always go through the
                                           # window-integral kernel's wrapper
    transport_incremental: str = "auto"    # persistent vacancy tunnel blocks: rows of atoms
                                           # already in the bucket are kept, only atoms that
                                           # entered it are recomputed (bit-identical to the
                                           # full assembly); "auto" = on while the blocks
                                           # fit 512 MiB; "on" | "off"
    transport_delta_cap: int = 16          # most newly entered bucket atoms recomputed per
                                           # solve; more falls back to the full assembly
    transport_banded: bool = True          # f32 inner matvec through the static banded
                                           # operator (current.build_banded_nb) plus a
                                           # vacancy-bucket correction; off, or a band above
                                           # 3 GiB, keeps the ELL gather
    batch_steps: int = 1                   # supersteps a batch (engine._run_bias_point_batched):
                                           # the t_end and Icc stops apply between them,
                                           # snapshot steps run alone; a host loop here

    # ------------------------------------------------------------------
    # derived parameters (reference: input_parser.cpp:391-398)
    # ------------------------------------------------------------------
    @property
    def high_G(self) -> float:
        return self.G_coeff * 1.0

    @property
    def low_G(self) -> float:
        return self.G_coeff * 1e-8

    @property
    def k(self) -> float:
        """Screened Coulomb prefactor [N m^2 / C^2]."""
        return COULOMB_K / self.epsilon

    @property
    def k_th_interface(self) -> float:
        return self.k_th_non_vacancy + (
            self.k_th_vacancies - self.k_th_non_vacancy
        ) * self.initial_vacancy_concentration

    @property
    def tau(self) -> float:
        """Thermal rate constant [1/s]."""
        return self.k_th_interface / (self.L_char * self.L_char * self.c_p * 1e6)

    @property
    def m_e(self) -> float:
        """Effective electron mass [kg]."""
        return self.m_r * M_0


_BOOL_KEYS = {
    "restart", "pristine", "shift", "pbc", "log_to_file", "verbose",
    "solve_potential", "solve_current", "solve_heating_global",
    "solve_heating_local", "perturb_structure", "transport_banded",
    "transport_bf16_inner", "boundary_incremental",
    "transport_skip_unchanged",
}
_INT_KEYS = {
    "rnd_seed", "rnd_seed_kmc", "log_freq", "output_freq", "batch_steps",
    "num_atoms_first_layer", "num_layers_contact", "num_atoms_contact",
    "num_atoms_reservoir", "solver_maxiter", "max_events_per_superstep",
    "num_layers", "poisson_compact_cap", "active_rows_cap", "tunnel_vac_cap",
    "tunnel_int_steps", "coarse_slabs", "coarse_yz", "solver_chunk_iters",
    "boundary_delta_cap", "transport_delta_cap",
}
_FLOAT_KEYS = {
    "initial_vacancy_concentration", "nn_dist", "Icc", "Rs", "sigma",
    "epsilon", "m_r", "V0", "k_therm", "background_temp",
    "dissipation_constant", "small_step", "event_time", "delta_t", "delta",
    "power_adjustment_term", "L_char", "k_th_metal", "k_th_non_vacancy",
    "k_th_vacancies", "c_p", "t_ox", "G_coeff", "solver_tol",
    "transport_tol",
}
_VEC_FLOAT_KEYS = {"lattice", "shifts", "V_switch", "t_switch", "alpha", "A"}
_VEC_STR_KEYS = {"metals"}
_STR_KEYS = {
    "restart_xyz_file", "atom_xyz_file", "interstitial_xyz_file",
    "precision", "selection", "output_dir", "event_mode", "heat_solver",
    "transport", "transport_precond", "boundary_precond", "bc_pinned_width",
    "site_order", "poisson_kernel", "transport_band_kernel",
    "ell_gather_kernel", "transport_cc", "tunnel_vm_kernel",
    "transport_incremental", "transport_warm_precond",
}
# reference key name -> config field name
_ALIASES = {"attempt_frequency": "freq"}

_LAYER_KEY = re.compile(r"^layer_(\d+)_(type|E_gen_0|E_rec_1|E_diff_2|E_diff_3|start_x|end_x)$")


def _parse_value(key: str, raw: str):
    raw = raw.replace(";", " ")
    toks = raw.split()
    if key in _BOOL_KEYS:
        return bool(int(float(toks[0])))
    if key in _INT_KEYS:
        return int(float(toks[0]))
    if key in _FLOAT_KEYS or key in _ALIASES:
        return float(toks[0])
    if key in _VEC_FLOAT_KEYS:
        vals = []
        for t in toks:
            t = t.rstrip(",").rstrip(";")
            if not t:
                continue
            try:
                vals.append(float(t))
            except ValueError:
                continue  # e.g. the "*" in "A = w * h" (input_parser.cpp:351-366)
        return vals
    if key in _VEC_STR_KEYS:
        return list(toks)
    if key in _STR_KEYS:
        return toks[-1] if toks else ""
    return None


def parse_parameters(path: str) -> KMCConfig:
    """Parse a reference-compatible ``parameters.txt`` into a KMCConfig:
    ``//`` comments, ``key = value`` lines, vectors as whitespace/comma
    separated floats.  The key ``A`` multiplies its components together
    (input_parser.cpp:235-241).  Layer-table keys (``num_layers``,
    ``layer_<i>_<field>``) and the framework's own knobs are accepted too.
    """
    cfg = KMCConfig()
    layer_overrides = {}
    num_layers: Optional[int] = None

    with open(path) as f:
        for line in f:
            line = line.split("//", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, raw = line.split("=", 1)
            key = key.strip()
            raw = raw.strip()
            if not key or not raw:
                continue

            m = _LAYER_KEY.match(key)
            if m:
                idx, fname = int(m.group(1)), m.group(2)
                layer_overrides.setdefault(idx, {})[fname] = (
                    raw.split()[0] if fname == "type" else float(raw.split()[0])
                )
                continue
            if key == "num_layers":
                num_layers = int(float(raw.split()[0]))
                continue

            field_name = _ALIASES.get(key, key)
            if field_name not in {f.name for f in dataclasses.fields(KMCConfig)}:
                continue
            val = _parse_value(key, raw)
            if val is None:
                continue
            if key == "A":
                prod = 1.0
                for v in val:
                    prod *= v
                val = prod
            setattr(cfg, field_name, val)

    # assemble the layer table
    if num_layers is not None:
        base = default_layers()
        cfg.layers = [
            base[i] if i < len(base) else Layer() for i in range(num_layers)
        ]
    for idx, over in sorted(layer_overrides.items()):
        while idx >= len(cfg.layers):
            cfg.layers.append(Layer())
        for fname, v in over.items():
            setattr(cfg.layers[idx], fname, v)

    return cfg
