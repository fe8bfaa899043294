"""CLI argument handling: a flag for every option leaf.

Port of the JAX package's `cli/common.py` (reference cli/cli_options.cpp
:59-130 + cli/bal_cli_utils.cpp:52-135): every leaf of the options
dataclasses becomes a kebab-case flag, dataset and solver leaves at the
top level; -C/--directory, --config (TOML) and --dump-config.

Differences: `--device` (default 'cuda') takes the place of jax's
`--platform`; a bool flag also takes an explicit value
(`--use-double false`) besides `--use-double` / `--no-use-double`; and
'%' in help texts is escaped, so `--help` works.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

from rootba_tpu_torch.config.options import (
    BalAppOptions,
    SolverType,
    StrEnum,
    dump_toml,
    iter_leaves,
    load_toml,
    update_from_dict,
)

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _bool_value(s: str) -> bool:
    v = s.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def _cli_name(path: str) -> str:
    return "--" + path.replace(".", "-").replace("_", "-")


def add_options_to_parser(parser: argparse.ArgumentParser, obj, prefix=""):
    for path, f, owner in iter_leaves(obj, prefix):
        flag = _cli_name(path)
        cur = getattr(owner, f.name)
        # argparse %-formats help strings
        help_text = (f.metadata or {}).get("help", "").replace("%", "%%")
        dest = path.replace(".", "__")
        if isinstance(cur, bool):
            group = parser.add_mutually_exclusive_group()
            group.add_argument(flag, dest=dest, nargs="?", const=True,
                               type=_bool_value, default=None,
                               metavar="BOOL", help=help_text)
            group.add_argument(
                "--no-" + flag[2:], dest=dest, action="store_false",
                default=None, help=argparse.SUPPRESS)
        elif isinstance(cur, StrEnum):
            choices = [m.value for m in type(cur)]
            parser.add_argument(flag, dest=dest, type=str, default=None,
                                help=f"{help_text} (possible values: "
                                     f"{', '.join(choices)})")
        elif isinstance(cur, int):
            parser.add_argument(flag, dest=dest, type=int, default=None,
                                help=help_text)
        elif isinstance(cur, float):
            parser.add_argument(flag, dest=dest, type=float, default=None,
                                help=help_text)
        elif isinstance(cur, list):
            parser.add_argument(flag, dest=dest, nargs="+", default=None,
                                help=help_text)
        else:
            parser.add_argument(flag, dest=dest, type=str, default=None,
                                choices=(f.metadata or {}).get("choices"),
                                help=help_text)


def apply_parsed(obj, args: argparse.Namespace, prefix=""):
    for path, f, owner in iter_leaves(obj, prefix):
        val = getattr(args, path.replace(".", "__"), None)
        if val is None:
            continue
        cur = getattr(owner, f.name)
        if isinstance(cur, StrEnum):
            val = type(cur).parse(val)
        setattr(owner, f.name, val)


def parse_bal_app_arguments(
    summary: str,
    argv: Optional[List[str]] = None,
    forced_solver_type: Optional[str] = None,
) -> Optional[Tuple[BalAppOptions, str]]:
    """(options, device name), or None when the app should exit (after
    --dump-config). CLI > config file > defaults, like
    parse_bal_app_arguments (bal_cli_utils.cpp:52-135)."""
    parser = argparse.ArgumentParser(description=summary)
    parser.add_argument("-C", "--directory", default="",
                        help="change to given directory first")
    parser.add_argument("--config", default="rootba_config.toml",
                        help="path to config file")
    parser.add_argument("--dump-config", action="store_true",
                        help="print effective config and exit")
    parser.add_argument("--device", default="cuda",
                        help="torch device to solve on: 'cuda' (default; "
                             "an error without a card) or 'cpu'")

    options = BalAppOptions()
    add_options_to_parser(parser, options.dataset)
    add_options_to_parser(parser, options.solver)
    args = parser.parse_args(argv)

    if args.directory:
        os.chdir(args.directory)
        print(f"Changed working directory to: {os.getcwd()}")
    else:
        print(f"Working directory is: {os.getcwd()}")

    if os.path.exists(args.config):
        unknown: List[str] = []
        cfg = load_toml(args.config)
        # ignore reference batch-runner sections like the reference does
        cfg.pop("batch_run", None)
        cfg.pop("slurm", None)
        update_from_dict(options, cfg, unknown=unknown)
        if unknown:
            raise SystemExit(
                f"unused config keys in {args.config}: {unknown}")

    apply_parsed(options.dataset, args)
    apply_parsed(options.solver, args)
    if forced_solver_type is not None:
        options.solver.solver_type = SolverType.parse(forced_solver_type)

    if args.dump_config:
        print("Printing effective config.")
        print(dump_toml(options))
        return None
    return options, args.device
