"""Experiment loading (the role python/rootba/experiments.py plays in
the reference): an Experiment = one solver config run on a set of
problems, discovered from run-directory patterns, loaded from a TOML
spec with template/substitution expansion and spec-hash pickle caching
(reference experiments.py:39-48 caching, :298-460 grammar).

Spec grammar (TOML), compatible with the reference's:

    [options]
    base_path = "$config_dir"     # default
    cache_dir = "cache"
    filter_regex = "ladybug"      # optional sequence filter

    [[substitutions]]
    date = "2026-08-20"

    [[templates]]
    _name = "exp_it"
    _arguments = ["kind"]
    name = "${kind}"
    pattern = "runs/${date}*${kind}/*"

    [[experiments]]
    _template = { _name = "exp_it", kind = { _argument = "product", _value = ["qr32", "sc32"] } }
    # expands into one experiment per kind

    [[experiments]]
    name = "qr64"
    display_name = "sqrt-BA f64"
    pattern = "runs/${date}*qr64/*"
    extend = "qr32"               # start from another experiment's runs

Caching: each experiment pickles under a hash of its functional spec
keys (pattern / filter_regex / extend) + base path, so renaming the
display name does not invalidate the cache while changing the pattern
does. options.overwrite_cache = true forces a reload. The hash also
holds this package's name: the JAX package's copy of this module
writes the same spec to another file, so neither package ever
unpickles the other's classes.
"""

from __future__ import annotations

import copy
import glob
import hashlib
import json
import os
import pickle
import re
import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from rootba_tpu_torch.eval.run import Run

_CACHE_VERSION = "2"
# the package whose classes the pickles hold (part of the cache key)
_PACKAGE = "rootba_tpu_torch"
_VAR = re.compile(r"\$\{(\w+)\}")


def _sub_str(s: str, subs: dict):
    m = _VAR.fullmatch(s)
    if m and m.group(1) in subs:
        return subs[m.group(1)]  # whole-string: preserve value type
    return _VAR.sub(lambda mm: str(subs.get(mm.group(1), mm.group(0))), s)


def _expand(obj, subs: dict, templates: dict):
    if isinstance(obj, str):
        return _sub_str(obj, subs)
    if isinstance(obj, list):
        out = []
        for item in obj:
            r = _expand(item, subs, templates)
            if isinstance(item, dict) and "_template" in item:
                out.extend(r)  # template expansion splices into lists
            else:
                out.append(r)
        return out
    if isinstance(obj, dict):
        if "_template" in obj:
            return _expand_template(obj, subs, templates)
        return {k: _expand(v, subs, templates) for k, v in obj.items()}
    return obj


def _expand_template(obj: dict, subs: dict, templates: dict) -> list:
    tmpls = obj["_template"]
    if not isinstance(tmpls, list):
        tmpls = [tmpls]
    proto = {k: _expand(v, subs, templates)
             for k, v in obj.items() if not k.startswith("_")}
    results: List[dict] = [dict()]
    for t in tmpls:
        tdef = templates[t["_name"]]
        args = [k for k in t if not k.startswith("_")]
        targs = list(tdef.get("_arguments", []))
        if set(args) != set(targs):
            raise ValueError(
                f"template {t['_name']!r} requires arguments {targs}, "
                f"got {args}")
        # argument combinations ('product' arguments fan out)
        combos: List[dict] = [dict()]
        for a in args:
            v = t[a]
            if isinstance(v, dict) and v.get("_argument") == "product":
                vals = _expand(v["_value"], subs, templates)
                combos = [dict(c, **{a: val})
                          for c in combos for val in vals]
            else:
                ev = _expand(v, subs, templates)
                for c in combos:
                    c[a] = ev
        new_results = []
        for base_obj in results:
            for c in combos:
                s2 = dict(subs)
                s2.update(c)
                body = {k: _expand(v, s2, templates)
                        for k, v in tdef.items() if not k.startswith("_")}
                merged = copy.deepcopy(base_obj)
                merged.update(body)
                new_results.append(merged)
        results = new_results
    return [dict(r, **proto) for r in results]


@dataclass
class Experiment:
    name: str
    display_name: str
    pattern: str
    runs: Dict[str, Run] = field(default_factory=dict)

    @staticmethod
    def load(name: str, display_name: str, pattern: str,
             base_path: str = ".", filter_regex: Optional[str] = None,
             extend: Optional["Experiment"] = None) -> "Experiment":
        exp = Experiment(name=name, display_name=display_name,
                         pattern=pattern)
        if extend is not None:
            exp.runs = {k: copy.deepcopy(v)
                        for k, v in extend.runs.items()}
        patterns = pattern if isinstance(pattern, list) else [pattern]
        for pat in patterns:
            for d in sorted(glob.glob(os.path.join(base_path, pat))):
                if not os.path.isdir(d):
                    continue
                run = Run.load(d)
                if filter_regex and not re.search(filter_regex, run.name):
                    continue
                exp.runs[run.name] = run
        return exp

    def sequences(self, filter_regex: Optional[str] = None) -> List[str]:
        names = sorted(self.runs.keys())
        if filter_regex:
            names = [n for n in names if re.search(filter_regex, n)]
        return names


def load_experiments_config(path: str, overrides: Optional[dict] = None
                            ) -> dict:
    """Load + expand an experiments spec: defaults, ${var}
    substitutions, template expansion, command-line overrides."""
    with open(path, "rb") as fp:
        cfg = tomllib.load(fp)

    cfg.setdefault("options", {})
    opts = cfg["options"]
    opts.setdefault("base_path", "$config_dir")
    opts.setdefault("cache_dir", "cache")
    opts.setdefault("output_path", "results")
    opts.setdefault("filter_regex", None)
    opts.setdefault("overwrite_cache", False)
    cfg.setdefault("substitutions", [])
    cfg.setdefault("templates", [])
    cfg.setdefault("experiments", [])
    cfg.setdefault("results", [])

    for k, v in (overrides or {}).items():
        if v is not None:
            opts[k] = v

    subs: dict = {}
    for d in cfg["substitutions"]:
        for k, v in d.items():
            if k in subs:
                raise ValueError(f"substitution {k!r} defined twice")
            subs[k] = v

    templates = {t["_name"]: t for t in cfg["templates"]}

    cfg["experiments"] = _expand(cfg["experiments"], subs, templates)
    cfg["results"] = _expand(cfg["results"], subs, templates)

    config_dir = os.path.dirname(os.path.abspath(path))
    if isinstance(opts["base_path"], str):
        opts["base_path"] = opts["base_path"].replace(
            "$config_dir", config_dir)
    return cfg


def _spec_hash(spec: dict, base: str) -> str:
    """Cache key over the functionally relevant spec keys (reference
    Experiment.load_spec: pattern/filter_regex/extend only) and the
    package."""
    key = {
        "package": _PACKAGE,
        "version": _CACHE_VERSION,
        "base": base,
        "pattern": spec.get("pattern"),
        "filter_regex": spec.get("filter_regex"),
        "extend": spec.get("extend"),
    }
    return hashlib.sha1(
        json.dumps(key, sort_keys=True).encode()).hexdigest()[:16]


def load_all(spec_path: str, base_path: Optional[str] = None,
             use_cache: bool = True,
             overrides: Optional[dict] = None) -> Dict[str, Experiment]:
    """Load all experiments named in a TOML spec (see module docstring
    for the grammar)."""
    cfg = load_experiments_config(spec_path, overrides)
    opts = cfg["options"]
    base = base_path or opts["base_path"]
    cache_dir = opts.get("cache_dir")
    overwrite = bool(opts.get("overwrite_cache"))
    global_filter = opts.get("filter_regex")

    out: Dict[str, Experiment] = {}
    for spec in cfg["experiments"]:
        name = spec["name"]
        if name in out:
            raise ValueError(f"experiment {name!r} is duplicate")
        pattern = spec["pattern"]
        display = spec.get("display_name", name)
        filter_regex = spec.get("filter_regex", global_filter)
        extend = out.get(spec["extend"]) if spec.get("extend") else None

        cache_file = None
        if cache_dir and use_cache:
            h = _spec_hash(spec, base)
            cache_file = os.path.join(base, cache_dir,
                                      f"{name}-{h}.pickle")
            if os.path.exists(cache_file) and not overwrite:
                try:
                    with open(cache_file, "rb") as fp:
                        exp = pickle.load(fp)
                    # name/display are not part of the cache key
                    exp.name = name
                    exp.display_name = display
                    out[name] = exp
                    continue
                except Exception:
                    pass
        exp = Experiment.load(name, display, pattern, base,
                              filter_regex=filter_regex, extend=extend)
        out[name] = exp
        if cache_file:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            with open(cache_file, "wb") as fp:
                pickle.dump(exp, fp)
    return out
