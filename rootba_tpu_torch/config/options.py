"""Options framework (analog of rootba's VisitableOptions, reference
src/rootba/options/visitable_options.hpp), the port's own copy of the
JAX package's `config/options.py`, trimmed to the options the port reads.

Python dataclasses with field metadata play the role of the
VISITABLE_META macro: every leaf field carries default / help / range /
enum information that the TOML loader, the --dump-config printer and the
auto-generated CLI (cli/common.py) all visit generically.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List


def opt(default, help="", range=None, logscale=False, choices=None):
    """Declare an option leaf (analog of VISITABLE_META)."""
    meta = {"help": help, "range": range, "logscale": logscale,
            "choices": choices}
    if callable(default) and not isinstance(default, type):
        return field(default_factory=default, metadata=meta)
    if isinstance(default, (list, dict)):
        return field(default_factory=lambda: default.copy(), metadata=meta)
    return field(default=default, metadata=meta)


def suboptions(cls):
    """Declare a nested options struct."""
    return field(default_factory=cls, metadata={"nested": True})


# ---------------------------------------------------------------------------
# enums (string round-trip like wise_enum)
# ---------------------------------------------------------------------------

class StrEnum(str, enum.Enum):
    """String enum with reference-compatible (wise_enum) names."""

    def __str__(self) -> str:  # noqa: DunderStr
        return self.value

    @classmethod
    def parse(cls, s: str):
        try:
            return cls(str(s).upper())
        except ValueError:
            valid = ", ".join(m.value for m in cls)
            raise ValueError(
                f"invalid value {s!r} for {cls.__name__}; valid: {valid}"
            ) from None


class DatasetType(StrEnum):
    AUTO = "AUTO"
    ROOTBA = "ROOTBA"
    BAL = "BAL"
    BUNDLER = "BUNDLER"


class RobustNorm(StrEnum):
    NONE = "NONE"
    HUBER = "HUBER"


class SolverType(StrEnum):
    SQUARE_ROOT = "SQUARE_ROOT"
    SCHUR_COMPLEMENT = "SCHUR_COMPLEMENT"
    POWER_SCHUR_COMPLEMENT = "POWER_SCHUR_COMPLEMENT"
    # external-baseline path (scipy stands in for the reference's Ceres)
    CERES = "CERES"


class PreconditionerType(StrEnum):
    IDENTITY = "IDENTITY"
    DIAGONAL = "DIAGONAL"
    JACOBI = "JACOBI"
    SCHUR_JACOBI = "SCHUR_JACOBI"
    POWER_SCHUR_COMPLEMENT = "POWER_SCHUR_COMPLEMENT"


class OptimizedCost(StrEnum):
    ERROR = "ERROR"
    ERROR_VALID = "ERROR_VALID"
    ERROR_VALID_AVG = "ERROR_VALID_AVG"


# ---------------------------------------------------------------------------
# options structs (defaults mirror the reference's)
# ---------------------------------------------------------------------------

@dataclass
class BalResidualOptions:
    """Reference: src/rootba/bal/bal_residual_options.hpp:44-65."""

    robust_norm: RobustNorm = opt(
        RobustNorm.NONE, help="robust norm: None (squared) or Huber")
    huber_parameter: float = opt(
        1.0, help="huber parameter in pixels", range=(0, 10))


@dataclass
class BaLogOptions:
    """Reference: src/rootba/bal/ba_log_options.hpp:43-60."""

    log_path: str = opt("ba_log.json", help="path of BA log file")
    save_log_flags: List[str] = opt(
        lambda: ["JSON"], help="log file types to save: JSON and/or UBJSON")
    disable_all: bool = opt(False, help="don't log anything")


@dataclass
class BalDatasetOptions:
    """Reference: src/rootba/bal/bal_dataset_options.hpp:44-95."""

    input: str = opt("", help="input dataset file to load")
    input_type: DatasetType = opt(
        DatasetType.AUTO, help="type of dataset to load")
    save_output: bool = opt(False, help="save optimization result")
    output_optimized_path: str = opt(
        "optimized.npz", help="output file for optimized problem")
    normalize: bool = opt(
        True, help="normalize scale and global position of the BA map")
    normalization_scale: float = opt(100.0)
    rotation_sigma: float = opt(
        0.0, help="stddev of camera rotation perturbation")
    translation_sigma: float = opt(
        0.0, help="stddev of camera translation perturbation")
    point_sigma: float = opt(0.0, help="stddev of point perturbation")
    random_seed: int = opt(
        38401, help="seed for the perturbation RNG; negative = random device")
    init_depth_threshold: float = opt(
        0.0, help="filter observations closer than this after load (0 = off)")
    quiet: bool = opt(False, help="skip INFO output when loading data")


@dataclass
class SolverOptions:
    """Reference: src/rootba/bal/solver_options.hpp:46-283, trimmed to the
    options the port reads. The JAX package's knobs of paths the port
    does not have (the host driver's calibration timing, a departure by
    design) are left out, so setting one is an unknown-key or
    unknown-flag error."""

    solver_type: SolverType = opt(
        SolverType.SQUARE_ROOT,
        help="SquareRoot | SchurComplement | PowerSchurComplement | "
             "Ceres (the host baselines of solver/numpy_lm.py and "
             "solver/scipy_baseline.py, see baseline_method)")
    verbosity_level: int = opt(2, help="0 silent, 1 brief, 2 full",
                               range=(0, 2))
    debug: bool = opt(False, help="print extra debug info")
    num_threads: int = opt(
        0, help="host thread hint (0 = auto), copied into ba_log.json's "
                "num_threads_given; torch manages device parallelism")

    residual: BalResidualOptions = suboptions(BalResidualOptions)
    log: BaLogOptions = suboptions(BaLogOptions)

    optimized_cost: OptimizedCost = opt(
        OptimizedCost.ERROR,
        help="cost used for the LM decrease check: Error | ErrorValid | "
             "ErrorValidAvg")

    max_num_iterations: int = opt(20, help="max LM iterations",
                                  range=(0, 10000))
    min_relative_decrease: float = opt(0.0)
    initial_trust_region_radius: float = opt(1e4, logscale=True)
    min_trust_region_radius: float = opt(1e-32, logscale=True)
    max_trust_region_radius: float = opt(1e16, logscale=True)
    min_lm_diagonal: float = opt(
        1e-6, logscale=True,
        help="CERES baseline only (like the reference: manual solvers "
             "ignore it, ceres/option_utils.cpp:97-98)")
    max_lm_diagonal: float = opt(
        1e32, logscale=True,
        help="CERES baseline only (like the reference)")
    min_linear_solver_iterations: int = opt(0)
    max_linear_solver_iterations: int = opt(500)
    eta: float = opt(1e-1, help="CG forcing-sequence / q-tolerance")
    jacobi_scaling: bool = opt(True)
    jacobi_scaling_epsilon: float = opt(
        0.0, help="0 means sqrt(machine eps) for the active dtype")
    preconditioner_type: PreconditionerType = opt(
        PreconditionerType.SCHUR_JACOBI,
        help="SchurJacobi | Jacobi | Diagonal | PowerSchurComplement "
             "(the last for the SCHUR_COMPLEMENT solver only)")
    function_tolerance: float = opt(1e-6)
    gradient_tolerance: float = opt(
        0.0, help="CERES baseline termination (gtol); the manual "
                  "solvers use function_tolerance only, like the "
                  "reference optimize_lm_ours")
    parameter_tolerance: float = opt(
        0.0, help="CERES baseline termination (xtol); manual solvers "
                  "ignore it, like the reference")
    baseline_method: str = opt(
        "trf", help="CERES-baseline backend: 'trf' (scipy "
                    "least_squares trust-region-reflective; final-cost "
                    "cross-checks) or 'lm' (plain-numpy LM running the "
                    "reference's exact lambda/nu/rho protocol with "
                    "dense Schur-complement normal equations; "
                    "step-comparable per-iteration trajectories)",
        choices=("trf", "lm"))

    use_double: bool = opt(True, help="float64 instead of float32")
    use_householder_marginalization: bool = opt(
        True, help="accepted but inert: the sqrt solver always uses "
                   "batched Householder-QR projection")
    staged_execution: bool = opt(
        True, help="accepted but inert: the stages always run in one "
                   "attempt body")
    reduction_alg: int = opt(
        1, help="per-camera sums of the implicit SQUARE_ROOT operator "
                "and of the SC/PoBA stages (jacobi scaling, right-hand "
                "side, PoBA's implicit E0 sweep): 0 scatter-adds "
                "(index_add_); any other value gathers each camera's "
                "slots through the camera CSR index and sums them in a "
                "fixed order")
    power_order: int = opt(
        10, help="max inner iterations of Power SC preconditioner/solver")
    initial_vee: float = opt(2.0)
    vee_factor: float = opt(2.0)

    # --- routing of the flat SQUARE_ROOT solver -------------------------
    kernel_layout: str = opt(
        "flat", help="SquareRoot solver data layout: 'flat' (default) "
                     "uses 2-D per-bucket landmark-row tables; 'einsum' "
                     "uses per-bucket [L,n,2,9] batched tensors (used "
                     "automatically for multi-device meshes)",
        choices=("flat", "einsum"))
    lm_loop: str = opt(
        "auto", help="'fused' runs the LM attempt loop (one host sync "
                     "per attempt); 'host' runs the reference's "
                     "driver (an outer loop per linearization, "
                     "backtracking attempts inside, the same attempt "
                     "body); 'auto' picks fused up to "
                     "fused_obs_threshold observations and host above",
        choices=("auto", "fused", "host"))
    fused_obs_threshold: int = opt(
        2_000_000, help="observation count above which lm_loop='auto' "
                        "picks the host driver")
    timing_mode: str = opt(
        "fast", help="'measured' runs the host LM loop whatever lm_loop "
                     "says; 'fast' (default) leaves the choice to "
                     "lm_loop. Stage times come from CUDA events at the "
                     "stage boundaries in either mode",
        choices=("fast", "measured"))
    num_devices: int = opt(
        0, help="number of ranks of the process group to shard landmark "
                "blocks over (parallel/mesh.py): 0 = every rank, 1 = no "
                "mesh, k > 1 must be the world size; without a process "
                "group 0 runs unsharded and k > 1 is an error")
    checkpoint_path: str = opt(
        "", help="mid-solve checkpoint file (npz); if it exists, the "
                 "host-loop LM driver resumes from it (same solver "
                 "config required). Empty disables checkpointing. The "
                 "fused device loop does not checkpoint (it is for "
                 "small/fast problems); use lm_loop=host for "
                 "checkpointed runs")
    checkpoint_interval: int = opt(
        0, help="write the checkpoint every this many LM iterations "
                "(0 = only resume, never write)")
    dense_rcs_max_cameras: int = opt(
        2048, help="assemble the reduced camera system as one dense "
                   "[9N, 9N] matrix (CG by dense GEMVs) when "
                   "num_cameras <= this; above it sqrt_rcs_mode='auto' "
                   "picks the block-sparse mode ('bsr')")
    pair_gather: str = opt(
        "stream", help="explicit-RCS pair-product gather formulation: "
                       "'stream' (default) tiles every pair slot into "
                       "per-bucket sub-streams of camera-sorted "
                       "landmarks, gathers from bounded sub-tables and "
                       "folds runs -- cost O(slots) regardless of "
                       "covisibility regularity; 'obs' gathers the two "
                       "per-observation rows from the flat [O,27] strip "
                       "and sums each pair's runs through a second-level "
                       "index",
        choices=("stream", "obs"))
    pallas_cg: str = opt(
        "auto", help="run the whole dense-RCS PCG loop as one CUDA "
                     "kernel (K3, csrc/cg_dense.cu): 'auto' in float32 "
                     "dense mode when the 128-lane padded system is at "
                     "most 12 MB (N <= 128 cameras); 'off' disables; "
                     "'on' forces it in float32 dense mode",
        choices=("auto", "on", "off"))
    sqrt_rcs_mode: str = opt(
        "auto", help="SQUARE_ROOT CG operator: 'implicit' applies "
                     "(Q2'Jp)'(Q2'Jp) matrix-free per CG iteration; "
                     "'dense' assembles the reduced camera system once "
                     "per stage2 and runs CG on it; 'bsr' assembles "
                     "only its 9x9 blocks of camera pairs that share a "
                     "landmark and runs CG on the block-sparse "
                     "operator; 'auto' picks dense when num_cameras <= "
                     "dense_rcs_max_cameras, bsr above it, implicit "
                     "under a forced JACOBI preconditioner",
        choices=("auto", "dense", "implicit", "bsr"))
    bsr_pack_max_gb: float = opt(
        4.0, help="BSR CG: expand the block table once per stage2 into "
                  "the run-major packed table (both directions of every "
                  "pair block, a second copy of the [2P, 81] blocks, "
                  "read in row slices by each matvec) only while it "
                  "stays under this many GB; above it the matvec "
                  "gathers both directions from the half table of "
                  "[P, 81] strict-pair blocks on every application")
    compensated_accumulation: bool = opt(
        True, help="float32: accumulate the CG dot products and the "
                   "model-cost decrease l_diff with error-free "
                   "transforms (ops/compensated.py); no effect in "
                   "float64. The whole-loop CG kernel keeps plain "
                   "float32 dots")
    bucket_pow2_from: int = opt(
        9, help="bucket obs-counts exactly up to this, then pad to pow2 "
               "(mirrors the reference's static-size landmark blocks 2..8, "
               "landmark_block.cpp:48-83)")

    def __post_init__(self):
        # free-form string options: a typo must error, not silently
        # fall back to default behavior
        for f in fields(self):
            _check_choice(f, getattr(self, f.name), f.name)

    def use_projection_validity_check(self) -> bool:
        return self.optimized_cost != OptimizedCost.ERROR

    def warn_inert_knobs(self) -> None:
        """One-line warning per CERES-only knob set to a non-default
        value, which the manual solvers do not act on (the reference
        maps min/max_lm_diagonal to Ceres only, option_utils.cpp:96-97).
        The JAX package's warning also names three inert knobs of its
        own; the port documents those in their help texts."""
        import warnings

        inert = [
            ("min_lm_diagonal", self.min_lm_diagonal, 1e-6),
            ("max_lm_diagonal", self.max_lm_diagonal, 1e32),
        ]
        for name, value, default in inert:
            if value != default:
                warnings.warn(
                    f"solver option '{name}={value}' is accepted but "
                    f"inert in the manual solvers (CERES baseline only "
                    f"for min/max_lm_diagonal)", stacklevel=3)


@dataclass
class BalAppOptions:
    """Aggregate app options (reference bal_app_options.hpp:44-53)."""

    dataset: BalDatasetOptions = suboptions(BalDatasetOptions)
    solver: SolverOptions = suboptions(SolverOptions)


# ---------------------------------------------------------------------------
# generic visitation: dict <-> dataclass, TOML, flat CLI leaves
# ---------------------------------------------------------------------------

def to_dict(obj) -> Dict[str, Any]:
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if is_dataclass(v):
            out[f.name] = to_dict(v)
        elif isinstance(v, StrEnum):
            out[f.name] = str(v)
        else:
            out[f.name] = v
    return out


def _convert(value, typ, path):
    if isinstance(typ, type) and issubclass(typ, StrEnum):
        if isinstance(value, typ):
            return value
        return typ.parse(str(value))
    if typ is float and isinstance(value, (int, float)):
        return float(value)
    if typ is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"option {path}: expected int, got {value!r}")
        return value
    if typ is bool and not isinstance(value, bool):
        raise ValueError(f"option {path}: expected bool, got {value!r}")
    return value


def _check_choice(f, value, path: str) -> None:
    """ValueError naming the allowed values when a string option with
    `choices` holds another value."""
    values = (f.metadata or {}).get("choices")
    if values is not None and value not in values:
        raise ValueError(f"option {path}={value!r} is not one of "
                         f"{values}")


def update_from_dict(obj, d: Dict[str, Any], path="", unknown=None):
    """In-place update from a (possibly partial) nested dict.

    Collects unknown keys like the reference's unused-key detection
    (options_interface.cpp:86-170).
    """
    hints = {f.name: f for f in fields(obj)}
    for k, v in d.items():
        p = f"{path}.{k}" if path else k
        if k not in hints:
            if unknown is not None:
                unknown.append(p)
            continue
        f = hints[k]
        cur = getattr(obj, k)
        if is_dataclass(cur):
            if not isinstance(v, dict):
                raise ValueError(f"option {p}: expected table/dict")
            update_from_dict(cur, v, p, unknown)
        else:
            v = _convert(v, type(cur), p)
            _check_choice(f, v, p)
            setattr(obj, k, v)
    return obj


def iter_leaves(obj, prefix=""):
    """Yield (dotted_path, field, owner) for every leaf option."""
    for f in fields(obj):
        v = getattr(obj, f.name)
        p = f"{prefix}.{f.name}" if prefix else f.name
        if is_dataclass(v):
            yield from iter_leaves(v, p)
        else:
            yield p, f, obj


def load_toml(path: str):
    import tomllib

    with open(path, "rb") as fp:
        return tomllib.load(fp)


def dump_toml(obj, fp=None):
    """Dump options as TOML text (simple writer, no external deps)."""
    lines: List[str] = []

    def fmt(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int,)):
            return str(v)
        if isinstance(v, float):
            return repr(v)
        if isinstance(v, StrEnum):
            return f'"{v}"'
        if isinstance(v, str):
            return f'"{v}"'
        if isinstance(v, list):
            return "[" + ", ".join(fmt(x) for x in v) + "]"
        raise TypeError(f"cannot dump {type(v)}")

    def walk(o, prefix):
        scalars = []
        nested = []
        for f in fields(o):
            v = getattr(o, f.name)
            if is_dataclass(v):
                nested.append((f.name, v))
            else:
                scalars.append((f.name, v))
        if prefix:
            lines.append(f"[{prefix}]")
        for name, v in scalars:
            lines.append(f"{name} = {fmt(v)}")
        lines.append("")
        for name, v in nested:
            walk(v, f"{prefix}.{name}" if prefix else name)

    walk(obj, "")
    text = "\n".join(lines)
    if fp is not None:
        fp.write(text)
    return text
