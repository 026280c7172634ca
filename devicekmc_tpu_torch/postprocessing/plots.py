"""Plotting tools over output.txt traces (reference: postprocessing/plot_*.py).

Each function doubles as a CLI:
    python -m devicekmc_tpu_torch.postprocessing.plots iv output.txt [out.png]
    python -m devicekmc_tpu_torch.postprocessing.plots current output.txt [out.png]
    python -m devicekmc_tpu_torch.postprocessing.plots temperature output.txt [out.png]
    python -m devicekmc_tpu_torch.postprocessing.plots conductance output.txt [out.png]
    python -m devicekmc_tpu_torch.postprocessing.plots power output.txt [out.png]
    python -m devicekmc_tpu_torch.postprocessing.plots timeline output.txt [out.png]
    python -m devicekmc_tpu_torch.postprocessing.plots timing output.txt [out.png]
    python -m devicekmc_tpu_torch.postprocessing.plots device snapshot.xyz [out.png]
"""

from __future__ import annotations

import sys

import numpy as np

from .parse import parse_output, parse_snapshot


def _save_or_show(fig, out):
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        print(f"wrote {out}")
    else:
        import matplotlib.pyplot as plt

        plt.show()


def plot_iv(path: str, out: str = ""):
    """I-V sweep: final current at each bias point (plot_IV.py)."""
    import matplotlib.pyplot as plt

    tr = parse_output(path)
    v = tr.voltages
    i = tr.final_per_bias("Current [uA]")
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(v, i, marker="o", markersize=3)
    ax.set_xlabel("Applied Voltage (V)")
    ax.set_ylabel("Current (uA)")
    ax2 = ax.twinx()
    ax2.plot(v, np.abs(i), linestyle="--", alpha=0.5, color="tab:orange")
    ax2.set_yscale("log")
    ax2.set_ylabel("|Current| (uA, log)")
    ax.set_title("I-V sweep")
    _save_or_show(fig, out)
    return v, i


def _plot_timeseries(path, key, ylabel, out, logy=False):
    import matplotlib.pyplot as plt

    tr = parse_output(path)
    t = tr.concat_time() * 1e9
    y = tr.concat(key)
    n = min(len(t), len(y))
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(t[:n], y[:n], marker=".", markersize=2)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("KMC time (ns)")
    ax.set_ylabel(ylabel)
    _save_or_show(fig, out)
    return t[:n], y[:n]


def plot_current(path: str, out: str = ""):
    return _plot_timeseries(path, "Current [uA]", "Current (uA)", out)


def plot_temperature(path: str, out: str = ""):
    return _plot_timeseries(
        path, "Global temperature [K]", "Global temperature (K)", out
    )


def plot_conductance(path: str, out: str = ""):
    return _plot_timeseries(path, "Conductance [uS]", "Conductance (uS)", out)


def plot_power(path: str, out: str = ""):
    return _plot_timeseries(
        path, "Total dissipated power [mW]", "Dissipated power (mW)", out
    )


def plot_kmc_timeline(path: str, out: str = ""):
    """KMC clock vs step number (plot_kmc_timeline.py)."""
    import matplotlib.pyplot as plt

    tr = parse_output(path)
    t = tr.concat_time()
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(np.arange(len(t)), t * 1e9, marker=".", markersize=2)
    ax.set_xlabel("KMC step")
    ax.set_ylabel("KMC time (ns)")
    _save_or_show(fig, out)
    return t


def plot_timing(path: str, out: str = ""):
    """Per-module wall-clock boxplots (timing_boxplot.py)."""
    import matplotlib.pyplot as plt

    tr = parse_output(path)
    keys = sorted(
        {
            k
            for bp in tr.bias_points
            for k in bp.series
            if k.startswith("Z - calculation time")
        }
    )
    data = [tr.concat(k) for k in keys]
    labels = [
        k.replace("Z - calculation time - ", "").replace(" [s]", "")
        for k in keys
    ]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.boxplot(data, tick_labels=labels)
    ax.set_yscale("log")
    ax.set_ylabel("wall time (s)")
    plt.setp(ax.get_xticklabels(), rotation=30, ha="right")
    _save_or_show(fig, out)
    return dict(zip(labels, data))


def show_device(path: str, out: str = "", axis: str = "z"):
    """Structure scatter coloured by species (show_device.py); defects and
    vacancies highlighted."""
    import matplotlib.pyplot as plt

    snap = parse_snapshot(path)
    coords = snap["coords"]
    elems = snap["elements"]
    ax_map = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}
    a, b = ax_map[axis]
    fig, ax = plt.subplots(figsize=(8, 4))
    colors = {"V": "red", "Od": "blue", "d": "0.9", "O": "0.6",
              "Hf": "0.4", "Ti": "gold", "N": "tan", "Pt": "silver",
              "Ni": "green"}
    for el in np.unique(elems):
        m = elems == el
        ax.scatter(
            coords[m, a], coords[m, b], s=4 if el in ("V", "Od") else 1,
            c=colors.get(el, "black"), label=el,
            zorder=3 if el in ("V", "Od") else 1,
        )
    ax.legend(markerscale=4, fontsize=7, ncol=2)
    ax.set_aspect("equal")
    _save_or_show(fig, out)


def extract_data(path: str, out: str = "extracted.npz"):
    """Scrape all series to npz or MATLAB .mat (reference: extract_data.py
    writes .mat); the format follows the output extension."""
    tr = parse_output(path)
    arrays = {"kmc_time": tr.concat_time(), "voltages": tr.voltages}
    keys = {k for bp in tr.bias_points for k in bp.series}
    for k in keys:
        name = (k.replace(" ", "_").replace("[", "").replace("]", "")
                 .replace("-", "_").replace("__", "_"))
        arrays[name] = tr.concat(k)
    if out.endswith(".mat"):
        from scipy.io import savemat

        savemat(out, arrays)
    else:
        np.savez(out, **arrays)
    print(f"wrote {out}")
    return arrays


def spy_csr(step_or_path: str, out: str = "", prefix: str = "."):
    """Sparsity spy plot of a dumped CSR matrix (reference: spy_CSR.py /
    spy_matrix_COO.py / plot_sparsity_txt.py).  Accepts either a step number
    (reads csr*_step#K.txt from ``prefix``) or a save_CSR_format file."""
    import matplotlib.pyplot as plt

    from ..io.matrix_debug import load_csr_txt

    if step_or_path.isdigit():
        row_ptr, cols, vals = load_csr_txt(int(step_or_path), prefix)
    else:
        with open(step_or_path) as f:
            vals = np.array(f.readline().split(), dtype=float)
            cols = np.array(f.readline().split(), dtype=int)
            row_ptr = np.array(f.readline().split(), dtype=int)
    n = len(row_ptr) - 1
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(cols, rows, s=0.2, marker="s", c="k")
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.set_title(f"nnz = {len(vals)}")
    _save_or_show(fig, out)


def plot_bond_current(npz_path: str, out: str = "", axis: str = "z"):
    """Quiver plot of the bond-current flow field exported by
    devicekmc_tpu_torch.physics.current.compute_bond_currents (reference:
    plot_bond_current.py, plotly isosurface over a dumped X matrix)."""
    import matplotlib.pyplot as plt

    data = np.load(npz_path)
    pos, vec, mag = data["positions"], data["I_vec"], data["I_out"]
    ax_map = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}
    a, b = ax_map[axis]
    fig, axp = plt.subplots(figsize=(8, 4))
    keep = mag > np.percentile(mag[mag > 0], 50) if (mag > 0).any() else mag > -1
    sc = axp.scatter(pos[:, a], pos[:, b], c=np.log10(np.maximum(mag, 1e-30)),
                     s=3, cmap="inferno")
    axp.quiver(pos[keep, a], pos[keep, b], vec[keep, a], vec[keep, b],
               angles="xy", width=0.002, alpha=0.6)
    fig.colorbar(sc, label="log10 |I_out| (A)")
    axp.set_aspect("equal")
    _save_or_show(fig, out)


_COMMANDS = {
    "iv": plot_iv,
    "current": plot_current,
    "temperature": plot_temperature,
    "conductance": plot_conductance,
    "power": plot_power,
    "timeline": plot_kmc_timeline,
    "timing": plot_timing,
    "device": show_device,
    "extract": extract_data,
    "spy": spy_csr,
    "bonds": plot_bond_current,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in _COMMANDS:
        print(__doc__)
        sys.exit(1)
    cmd, path = argv[0], argv[1]
    out = argv[2] if len(argv) > 2 else ""
    import matplotlib

    matplotlib.use("Agg")
    _COMMANDS[cmd](path, out)


if __name__ == "__main__":
    main()
