"""YAML experiment specs -> hyperparameter-grid variants (counterpart:
ilswiss_tpu/launchers/variant.py, of which this is a copy).

Rebuild of the reference's launcher utilities
(rlkit/launchers/launcher_util.py): the spec format is identical —
`meta_data` (script/worker info), `variables` (grid axes; nested dicts
with lists at the leaves), `constants` (merged into every variant) —
so reference exp_specs port over directly.  `variables` are flattened to
dotted keys (launcher_util.py:404-421), cartesian-producted
(:435-464), re-nested (:424-432) and merged into `constants`; each
variant also gets an `exp_id`.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping


def flatten_dict(d: Mapping[str, Any], parent: str = "",
                 sep: str = ".") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{parent}{sep}{k}" if parent else k
        if isinstance(v, Mapping):
            out.update(flatten_dict(v, key, sep))
        else:
            out[key] = v
    return out


def unflatten_dict(d: Mapping[str, Any], sep: str = ".") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        parts = k.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _deep_merge(base: Dict[str, Any], extra: Mapping[str, Any]
                ) -> Dict[str, Any]:
    out = dict(base)
    for k, v in extra.items():
        if (k in out and isinstance(out[k], Mapping)
                and isinstance(v, Mapping)):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def check_exp_spec_format(spec: Mapping[str, Any]) -> None:
    """Schema check (reference launcher_util.py:388-401)."""
    for key in ("meta_data",):
        if key not in spec:
            raise ValueError(f"exp spec missing required section '{key}'")
    unknown = set(spec) - {"meta_data", "variables", "constants"}
    if unknown:
        raise ValueError(f"unknown exp spec sections: {sorted(unknown)}")
    variables = spec.get("variables") or {}
    for k, v in flatten_dict(variables).items():
        if not isinstance(v, list):
            # the reference's programmatic VariantGenerator supports
            # lambda-dependent variables (launcher_util.py:514-620);
            # its YAML spec path never uses them, and neither do we —
            # fail loudly rather than silently producing a wrong grid
            raise ValueError(
                f"variables leaf '{k}' must be a list of values, got "
                f"{v!r}. Dependent/computed variables (the reference's "
                "VariantGenerator lambda feature) are not supported in "
                "YAML specs — precompute the grid instead."
            )


def build_variants(spec: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Expand a spec into the full variant grid
    (reference build_nested_variant_generator, launcher_util.py:435-464)."""
    check_exp_spec_format(spec)
    constants = dict(spec.get("constants") or {})
    variables = spec.get("variables") or {}
    flat = flatten_dict(variables)

    if not flat:
        v = dict(constants)
        v["exp_id"] = 0
        return [v]

    keys = sorted(flat)
    variants = []
    for i, combo in enumerate(itertools.product(*(flat[k] for k in keys))):
        assignment = unflatten_dict(dict(zip(keys, combo)))
        v = _deep_merge(constants, assignment)
        v["exp_id"] = i
        variants.append(v)
    return variants
