"""Config system: HOCON-subset parsing, overrides, schema validation.

Counterpart of the JAX package's config/__init__.py (reference
code/main.py:56-109: parse + merge + schema check). Bare conf names resolve
against the port's own ``confs/``, a byte-for-byte copy of the JAX
package's (a test holds the two equal).
"""

import os

from gasfm_tpu_torch.config.hocon import (
    ConfigFactory,
    ConfigMissingError,
    ConfigTree,
    detect_schema_discrepancies,
    merge_external_params,
)

# Keys the JAX package reads (train/state.py build_optimizer and
# cast_params_for_training: bf16 second moments, bf16 weights with an f32
# master) that its ref.conf lacks, so that its CLI's schema check refuses
# them (its bench sets them on a conf it builds). The port's CLI takes them.
KEYS_BEYOND_SCHEMA = ("train.adam_nu_dtype", "train.param_dtype")

_CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "confs")


def confs_dir() -> str:
    return _CONF_DIR


def load_ref_schema() -> ConfigTree:
    return ConfigFactory.parse_file(os.path.join(_CONF_DIR, "ref.conf"))


def load_config(path: str, external_params=None, validate: bool = True) -> ConfigTree:
    """Load a runtime config file, merge CLI overrides, validate keys.

    Relative bare names resolve against the shipped ``confs/`` directory.
    The keys of ``KEYS_BEYOND_SCHEMA`` pass the check.
    """
    if not os.path.exists(path):
        candidate = os.path.join(_CONF_DIR, path)
        if os.path.exists(candidate):
            path = candidate
    conf = ConfigFactory.parse_file(path)
    conf.put("original_file_name", os.path.basename(path))
    if external_params:
        merge_external_params(conf, list(external_params))
    if validate:
        bad = [k for k in detect_schema_discrepancies(conf, load_ref_schema())
               if k not in KEYS_BEYOND_SCHEMA]
        if bad:
            raise ValueError(f"Unknown configuration keys (not in ref.conf schema): {bad}")
    return conf


__all__ = [
    "ConfigFactory",
    "ConfigMissingError",
    "ConfigTree",
    "KEYS_BEYOND_SCHEMA",
    "confs_dir",
    "detect_schema_discrepancies",
    "load_config",
    "load_ref_schema",
    "merge_external_params",
]
