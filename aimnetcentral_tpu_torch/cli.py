"""Command-line interface of the port (counterpart of the serving commands of
aimnetcentral_tpu/cli.py).

Commands: sp (single point), relax (FIRE), md, neb, freq, download,
clear-model-cache and info.  Every command runs on the card unless the
group's ``--device cpu`` is given:

    aimnet-torch sp model.pt water.xyz
    python -m aimnetcentral_tpu_torch.cli --device cpu sp model.pt water.xyz

Each command's body is a plain function (``run_sp``, ``run_relax``,
``run_md``, ``run_neb``, ``run_freq``, ``run_download``,
``run_clear_model_cache``, ``run_info``) that takes the options and
returns the lines or the dict the command prints; click only parses the
options and echoes, so the bodies also run where click is not installed.
The drivers get the calculator's own parameters, which live on its device.
"""

from __future__ import annotations

import json

import numpy as np

try:
    import click
except ImportError:  # pragma: no cover - the run_* bodies need no click
    click = None

PRECISION_HELP = (
    "'exact' (the default) runs FP32 matmuls throughout; 'fast' runs TF32 "
    "matmuls on the card's tensor cores, for screening; 'balanced' keeps the "
    "matmuls exact outside the conv kernels, and since the port's conv "
    "kernels contract in FP32 on the CUDA cores it computes what 'exact' "
    "does.  On the CPU the three give the same numbers"
)


class UsageError(ValueError):
    """An invalid combination of options (click reports it as a usage error)."""


def _load_calc(model: str, precision: str = "exact", device: str = "cuda"):
    from aimnetcentral_tpu_torch.calculators import AIMNet2Calculator
    from aimnetcentral_tpu_torch.calculators.registry import registry_family, resolve_model
    from aimnetcentral_tpu_torch.models.loader import load_model

    path = resolve_model(model)
    loaded = load_model(path, registry_family=registry_family(model))
    return AIMNet2Calculator(loaded.as_calculator_model(), precision=precision, device=device), loaded


def _load_ens_calc(model: str, fused: bool = True, precision: str = "exact", device: str = "cuda"):
    """The ensemble calculator of a registry family (all its members) or of
    a comma-separated list of artifact paths."""
    from aimnetcentral_tpu_torch.calculators.ensemble import EnsembleCalculator
    from aimnetcentral_tpu_torch.models.loader import load_model

    if "," in model:
        loaded = [load_model(p.strip()) for p in model.split(",")]
        return EnsembleCalculator.from_members(
            [ld.as_calculator_model() for ld in loaded], fused=fused, precision=precision, device=device
        )
    return EnsembleCalculator.from_registry(model, fused=fused, precision=precision, device=device)


def _read_structure(path: str):
    """An XYZ or CIF file: (coord, numbers, cell or None)."""
    from aimnetcentral_tpu_torch.io import read_cif, read_xyz

    if path.lower().endswith(".cif"):
        s = read_cif(path)
        return s["coord"], s["numbers"], s["cell"]
    coord, numbers = read_xyz(path)
    return coord, numbers, None


def _read_xyz(path: str):
    from aimnetcentral_tpu_torch.io import read_xyz

    return read_xyz(path)


def run_sp(model: str, xyz: str, charge: float = 0.0, forces: bool = True, ensemble: bool = False,
           precision: str = "exact", device: str = "cuda") -> list[str]:
    """Single-point energy (and forces; stress for a CIF) of an XYZ or CIF file."""
    if ensemble:
        calc = _load_ens_calc(model, precision=precision, device=device)
    else:
        calc, _ = _load_calc(model, precision=precision, device=device)
    coord, numbers, cell = _read_structure(xyz)
    data = {"coord": coord, "numbers": numbers, "charge": charge}
    if cell is not None:
        data["cell"] = cell
    out = calc(data, forces=forces, stress=cell is not None)
    if "energy_std" in out:
        lines = [f"energy (eV): {out['energy'][0]:.6f} +/- {out['energy_std'][0]:.6f} (ensemble spread)"]
    else:
        lines = [f"energy (eV): {out['energy'][0]:.6f}"]
    lines.append(f"charges: {np.round(out['charges'], 4).tolist()}")
    if forces:
        lines.append(f"max |force| (eV/A): {np.abs(out['forces']).max():.6f}")
    if "stress" in out:
        lines.append(f"stress (eV/A^3): {np.round(out['stress'], 6).tolist()}")
    return lines


def run_relax(model: str, xyz: str, fmax: float = 0.05, max_steps: int = 500, device: str = "cuda") -> dict:
    """FIRE relaxation on the calculator's device; returns FIRE's info."""
    from aimnetcentral_tpu_torch.dynamics import fire_relax

    calc, _loaded = _load_calc(model, device=device)
    coord, numbers = _read_xyz(xyz)
    system = calc.prepare_system({"coord": coord, "numbers": numbers})
    _relaxed, info = fire_relax(calc.params, calc.cfg, system, fmax=fmax, max_steps=max_steps)
    return info


def run_md(model: str, xyz: str, steps: int = 1000, temperature: float = 300.0, dt_fs: float = 0.5,
           cell: float | None = None, traj: str | None = None, chunk: int = 50, save_ckpt: str | None = None,
           restore_ckpt: str | None = None, ensemble: bool = False, thermostat: str = "langevin",
           pressure_gpa: float | None = None, precision: str | None = None, device: str = "cuda") -> dict:
    """MD through ``MDDriver`` on the System the calculator prepares (a box
    at or above its ``binned_threshold`` arrives binned and is binned again
    at the driver's skin, as in the JAX driver)."""
    from aimnetcentral_tpu_torch.dynamics import MDConfig, MDDriver, TrajectoryWriter

    if pressure_gpa is not None and cell is None:
        raise UsageError("--pressure-gpa (NPT) requires --cell")
    if ensemble:
        calc = _load_ens_calc(model, device=device)
    else:
        calc, _loaded = _load_calc(model, device=device)
    coord, numbers = _read_xyz(xyz)
    data = {"coord": coord, "numbers": numbers}
    if cell is not None:
        data["cell"] = np.eye(3, dtype=np.float32) * float(cell)
    system = calc.prepare_system(data)
    md_cfg = MDConfig(
        dt_fs=dt_fs,
        temperature_K=temperature,
        thermostat=thermostat,
        barostat="berendsen" if pressure_gpa is not None else None,
        pressure_eV_A3=(pressure_gpa or 0.0) * 6.2415e-3,  # 1 GPa = 6.2415e-3 eV/A^3
        precision=precision,
    )
    drv = MDDriver(calc.params, calc.cfg, system, md_cfg, ensemble=ensemble, device=calc.device)
    if restore_ckpt:
        drv.restore_checkpoint(restore_ckpt)
    writer = TrajectoryWriter(traj) if traj else None
    try:
        obs = drv.run(steps, chunk=chunk, traj=writer)
    finally:
        if writer is not None:
            writer.close()
    if save_ckpt:
        drv.save_checkpoint(save_ckpt)
    result = {
        "steps": steps,
        "final_epot_eV": float(obs["epot"][-1]),
        "mean_T_K": float(obs["temperature"][steps // 2 :].mean()),
    }
    if pressure_gpa is not None and "volume" in obs:
        result["final_volume_A3"] = float(obs["volume"][-1])
    if "epot_std" in obs:
        result["final_epot_std_eV"] = float(obs["epot_std"][-1])
    if writer is not None:
        result["traj_frames"] = writer.frames_written
    if save_ckpt:
        result["checkpoint"] = save_ckpt
    return result


def run_neb(model: str, reactant_xyz: str, product_xyz: str, n_images: int = 11, charge: float = 0.0,
            mult: float | None = None, fmax: float = 0.05, max_steps: int = 500, climb: bool = True,
            k_spring: float = 0.1, band: str | None = None, device: str = "cuda") -> dict:
    """Climbing-image NEB between two gas-phase endpoints, every image in one
    batched force call an iteration.  The barrier is relative to the
    reactant image (the SAE shift cancels); ``i_ts`` is the climbing image
    to refine with ``ts_search``."""
    from aimnetcentral_tpu_torch.dynamics.neb import neb as neb_band

    calc, _loaded = _load_calc(model, device=device)
    coord_r, numbers_r = _read_xyz(reactant_xyz)
    coord_p, numbers_p = _read_xyz(product_xyz)
    r = {"coord": coord_r, "numbers": numbers_r, "charge": charge}
    p = {"coord": coord_p, "numbers": numbers_p, "charge": charge}
    if mult is not None:
        r["mult"] = p["mult"] = mult
    band_t, energies_t, info = neb_band(
        calc.params, calc.cfg, r, p, n_images=n_images, device=calc.device,
        fmax=fmax, max_steps=max_steps, climb=climb, k_spring=k_spring,
    )
    energies = energies_t.detach().cpu().numpy().astype(np.float64)
    result = {
        "n_images": int(n_images),
        "steps": info["steps"],
        "fmax": round(float(info["fmax"]), 6),
        "converged": bool(info["converged"]),
        "i_ts": int(info["i_ts"]),
        "barrier_eV": round(float(energies.max() - energies[0]), 6),
        "reaction_energy_eV": round(float(energies[-1] - energies[0]), 6),
        "energies_rel_eV": [round(float(e - energies[0]), 6) for e in energies],
    }
    if band:
        from aimnetcentral_tpu_torch.dynamics import TrajectoryWriter

        with TrajectoryWriter(band) as w:
            for i, img in enumerate(band_t.detach().cpu().numpy()):
                w.write(numbers_r, img, comment={"image": i, "energy_rel_eV": f"{energies[i] - energies[0]:.6f}"})
        result["band"] = band
    return result


def run_freq(model: str, xyz: str, charge: float = 0.0, n_modes: int = 12, ir: bool = False, thermo: bool = False,
             temperature: float = 298.15, pressure: float = 101325.0, symmetry_number: int = 1, mult: float = 1.0,
             device: str = "cuda") -> dict:
    """Harmonic frequencies (cm^-1, imaginary ones negative) from the dense
    Hessian, with double-harmonic IR intensities (``ir``) and ideal-gas
    RRHO thermochemistry (``thermo``)."""
    from aimnetcentral_tpu_torch.dynamics import frequencies_from_calculator

    calc, _loaded = _load_calc(model, device=device)
    coord, numbers = _read_xyz(xyz)
    data = {"coord": coord, "numbers": numbers, "charge": charge}
    if mult != 1.0:
        data["mult"] = mult
    # thermochemistry implies a stationary point: project the rotations out
    # so that they cannot leak into the vibrational partition function
    freqs, modes = frequencies_from_calculator(calc, data, project_rotations=thermo)
    result = {
        "n_imaginary": int((freqs < -10.0).sum()),  # numerical near-zeros are not counted
        "lowest_cm1": [round(float(f), 2) for f in freqs[:n_modes]],
        "highest_cm1": round(float(freqs[-1]), 2),
    }
    if ir:
        from aimnetcentral_tpu_torch.dynamics.vibrations import ir_intensities

        intens = ir_intensities(calc, data, modes)
        result["ir_km_mol"] = [round(float(x), 3) for x in intens[:n_modes]]
    if thermo:
        from aimnetcentral_tpu_torch.dynamics.vibrations import rrho_thermochemistry

        result["thermo"] = {
            k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in rrho_thermochemistry(
                freqs, numbers, coord, temperature=temperature, pressure=pressure,
                symmetry_number=symmetry_number, mult=mult,
            ).items()
        }
    return result


def run_download(name: str) -> str:
    """Download a registry model into the cache; returns its path."""
    from aimnetcentral_tpu_torch.calculators.registry import download_model

    return download_model(name)


def run_clear_model_cache() -> str:
    from aimnetcentral_tpu_torch.calculators.registry import clear_model_cache

    clear_model_cache()
    return "model cache cleared"


def run_info(device: str = "cuda") -> list[str]:
    """The port's version, torch's, the card, the kernels' build, the model
    cache and the registry."""
    import torch

    import aimnetcentral_tpu_torch
    from aimnetcentral_tpu_torch.calculators.registry import available_models, cache_dir
    from aimnetcentral_tpu_torch.kernels.build import BUILD_DIR, SOURCES, _lib_path

    cuda = torch.cuda.is_available()
    built = [name for name in SOURCES if _lib_path(name).exists()]
    return [
        f"aimnetcentral_tpu_torch {aimnetcentral_tpu_torch.__version__}",
        f"torch {torch.__version__} (CUDA {torch.version.cuda})",
        f"cuda available: {cuda}"
        + (f", {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}" if cuda else ""),
        f"device: {device}",
        f"kernels built under {BUILD_DIR}: {len(built)} of {len(SOURCES)}"
        + (f" ({', '.join(built)})" if built else " (each builds with nvcc at its first launch)"),
        f"model cache: {cache_dir()}",
        f"registry models: {len(available_models())}",
    ]


if click is not None:

    def _run(body, *args, **kwargs):
        """Call a body, turning its ``UsageError`` into click's."""
        try:
            return body(*args, **kwargs)
        except UsageError as e:
            raise click.UsageError(str(e)) from e

    @click.group()
    @click.option(
        "--device",
        default="cuda",
        show_default=True,
        help="run on the card (cuda) or on the CPU (cpu: the kernels' plain versions); "
        "without a card only cpu runs",
    )
    @click.pass_context
    def cli(ctx, device: str) -> None:
        """aimnetcentral_tpu_torch: AIMNet2 potentials in PyTorch with CUDA kernels."""
        from aimnetcentral_tpu_torch.device import resolve_device

        ctx.obj = {"device": str(resolve_device(device))}

    @cli.command()
    @click.argument("model")
    @click.argument("xyz")
    @click.option("--charge", default=0.0)
    @click.option("--forces/--no-forces", default=True)
    @click.option(
        "--ensemble/--no-ensemble",
        default=False,
        help="load every member of a registry family (or MODEL as a comma-separated member list) and report "
        "mean +/- member spread",
    )
    @click.option("--precision", default="exact", type=click.Choice(["exact", "balanced", "fast"]), help=PRECISION_HELP)
    @click.pass_obj
    def sp(obj, model, xyz, charge, forces, ensemble, precision) -> None:
        """Single-point energy (and forces) for an XYZ or CIF file."""
        for line in _run(run_sp, model, xyz, charge, forces, ensemble, precision, obj["device"]):
            click.echo(line)

    @cli.command()
    @click.argument("model")
    @click.argument("xyz")
    @click.option("--fmax", default=0.05)
    @click.option("--max-steps", default=500)
    @click.pass_obj
    def relax(obj, model, xyz, fmax, max_steps) -> None:
        """FIRE geometry relaxation on the device."""
        click.echo(json.dumps(_run(run_relax, model, xyz, fmax, max_steps, obj["device"])))

    @cli.command()
    @click.argument("model")
    @click.argument("xyz")
    @click.option("--steps", default=1000)
    @click.option("--temperature", default=300.0)
    @click.option("--dt-fs", default=0.5)
    @click.option("--cell", default=None, type=float, help="cubic cell length (Angstrom)")
    @click.option("--traj", default=None, help="extxyz trajectory output path")
    @click.option("--chunk", default=50, help="steps a chunk (= trajectory stride)")
    @click.option("--save-ckpt", default=None, help="write a resume checkpoint here at the end")
    @click.option("--restore-ckpt", default=None, help="resume from a checkpoint written by --save-ckpt")
    @click.option(
        "--ensemble/--no-ensemble",
        default=False,
        help="mean-force MD over every member of a registry family (or a comma-separated member list); "
        "logs the members' epot spread",
    )
    @click.option(
        "--thermostat",
        default="langevin",
        type=click.Choice(["langevin", "nve", "berendsen"]),
        help="integrator/thermostat (nve = plain velocity Verlet)",
    )
    @click.option(
        "--pressure-gpa",
        default=None,
        type=float,
        help="enable the isotropic Berendsen barostat (NPT) at this target pressure; requires a periodic cell",
    )
    @click.option(
        "--precision",
        default=None,
        type=click.Choice(["balanced", "exact"]),
        help="the force evaluation's tier for NVE and drift-sensitive runs (the tiers of sp); the default is "
        "'fast' (TF32 matmuls on the card), fine under a thermostat",
    )
    @click.pass_obj
    def md(obj, model, xyz, steps, temperature, dt_fs, cell, traj, chunk, save_ckpt, restore_ckpt, ensemble,
           thermostat, pressure_gpa, precision) -> None:
        """MD on the device: Langevin NVT by default; --thermostat nve or
        berendsen, --pressure-gpa for Berendsen NPT."""
        click.echo(json.dumps(_run(
            run_md, model, xyz, steps, temperature, dt_fs, cell, traj, chunk, save_ckpt, restore_ckpt,
            ensemble, thermostat, pressure_gpa, precision, obj["device"],
        )))

    @cli.command()
    @click.argument("model")
    @click.argument("reactant_xyz")
    @click.argument("product_xyz")
    @click.option("--n-images", default=11, help="band resolution incl. endpoints")
    @click.option("--charge", default=0.0)
    @click.option("--mult", default=None, type=float, help="spin multiplicity (NSE models)")
    @click.option("--fmax", default=0.05, help="NEB-force convergence (eV/A)")
    @click.option("--max-steps", default=500)
    @click.option(
        "--climb/--no-climb", default=True, help="climbing-image NEB: drive the highest image uphill along the band"
    )
    @click.option("--k-spring", default=0.1, help="band spring constant (eV/A^2)")
    @click.option("--band", default=None, help="write the optimized band as extxyz here")
    @click.pass_obj
    def neb(obj, model, reactant_xyz, product_xyz, n_images, charge, mult, fmax, max_steps, climb, k_spring,
            band) -> None:
        """Climbing-image NEB between two gas-phase endpoints; prints a JSON
        summary with the barrier and the climbing image's index."""
        click.echo(json.dumps(_run(
            run_neb, model, reactant_xyz, product_xyz, n_images, charge, mult, fmax, max_steps, climb, k_spring,
            band, obj["device"],
        )))

    @cli.command()
    @click.argument("model")
    @click.argument("xyz")
    @click.option("--charge", default=0.0)
    @click.option("--n-modes", default=12, help="print the N lowest frequencies")
    @click.option("--ir", is_flag=True, help="double-harmonic IR intensities (km/mol)")
    @click.option("--thermo", is_flag=True, help="ideal-gas RRHO thermochemistry (ZPE/H/S/G) at --temperature")
    @click.option("--temperature", default=298.15)
    @click.option("--pressure", default=101325.0)
    @click.option("--symmetry-number", default=1)
    @click.option(
        "--mult",
        default=1.0,
        help="spin multiplicity: the electronic entropy kB*ln(mult) in --thermo (and the NSE models' input)",
    )
    @click.pass_obj
    def freq(obj, model, xyz, charge, n_modes, ir, thermo, temperature, pressure, symmetry_number, mult) -> None:
        """Harmonic vibrational frequencies (cm^-1) from the dense Hessian;
        imaginary modes print as negative numbers."""
        click.echo(json.dumps(_run(
            run_freq, model, xyz, charge, n_modes, ir, thermo, temperature, pressure, symmetry_number, mult,
            obj["device"],
        )))

    @cli.command()
    @click.argument("name")
    def download(name: str) -> None:
        """Download a registry model into the cache."""
        click.echo(run_download(name))

    @cli.command("clear-model-cache")
    def clear_model_cache_cmd() -> None:
        click.echo(run_clear_model_cache())

    @cli.command()
    @click.pass_obj
    def info(obj) -> None:
        """Versions, the card, the kernels' build and the model cache."""
        for line in run_info(obj["device"]):
            click.echo(line)

else:  # pragma: no cover

    def cli() -> None:
        raise ImportError("the aimnet-torch command needs click; the run_* functions of this module do not")


if __name__ == "__main__":
    cli()
