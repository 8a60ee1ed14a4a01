"""Strict attribute-dict config system with YAML loading and `--a:b v` CLI
overrides — the config surface of `neurecon_tpu.config`, kept as its own copy.

  * missing keys raise KeyError (a typo in a config is an error)
  * merge precedence: CLI overrides > config yaml > default yaml
  * `--section:key value` CLI args with type coercion from the existing value
  * `--resume_dir` mode reloads `exp_dir/config.yaml`

`yaml` is imported inside the functions that read YAML, so the package
imports on a machine without PyYAML; `save_config` writes YAML with an
emitter of its own and needs no PyYAML at all.
"""
from __future__ import annotations

import argparse
import copy
import os
from typing import Any, List, Optional, Tuple


class ConfigDict(dict):
    """dict with attribute access that raises on missing keys."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            for k, v in dict(arg).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, dict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, ConfigDict._wrap(value))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def get(self, key, default=None):
        v = super().get(key, default)
        return ConfigDict._wrap(v) if isinstance(v, dict) else v

    def update(self, other=None, **kwargs):
        items = list(dict(other).items()) if other else []
        items += list(kwargs.items())
        for k, v in items:
            self[k] = v

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = [x.to_dict() if isinstance(x, ConfigDict) else x for x in v]
            else:
                out[k] = v
        return out

    def __deepcopy__(self, memo):
        return ConfigDict(copy.deepcopy(self.to_dict(), memo))


def load_yaml(path: str, default_path: Optional[str] = None) -> ConfigDict:
    import yaml

    with open(path, encoding="utf8") as f:
        config = ConfigDict(yaml.safe_load(f))
    if default_path is not None and path != default_path:
        with open(default_path, encoding="utf8") as f:
            main = ConfigDict(yaml.safe_load(f))
        main.update(config)
        config = main
    return config


def save_config(config: ConfigDict, path: str):
    """Write the run's config as YAML (block style; `yaml.safe_load` reads it
    back to the same dict). `ckpt_file` is reset and `exp_dir` dropped, as
    the JAX package does."""
    config = copy.deepcopy(config)
    if "training" in config:
        config.training["ckpt_file"] = None
        config.training.pop("exp_dir", None)
    with open(path, "w", encoding="utf8") as f:
        f.write(dump_yaml(config.to_dict()))


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        mant, _, exp = r.partition("e")
        if exp and "." not in mant:  # YAML 1.1 floats need the dot: 1.0e-05
            r = f"{mant}.0e{exp}"
        return r
    return "'" + str(v).replace("'", "''") + "'"


def dump_yaml(d: dict, indent: int = 0) -> str:
    """Block-style YAML of nested dicts of scalars and lists."""
    pad = " " * indent
    out = []
    for k, v in d.items():
        key = _yaml_key(k)
        if isinstance(v, dict) and v:
            out.append(f"{pad}{key}:\n{dump_yaml(v, indent + 2)}")
        elif isinstance(v, dict):
            out.append(f"{pad}{key}: {{}}\n")
        elif isinstance(v, (list, tuple)) and any(isinstance(x, (dict, list, tuple)) for x in v):
            out.append(f"{pad}{key}:\n")
            for x in v:
                if isinstance(x, dict) and x:
                    body = dump_yaml(x, indent + 4)
                    out.append(f"{pad}  - {body[indent + 4:]}")
                else:
                    out.append(f"{pad}  - {_yaml_flow(x)}\n")
        elif isinstance(v, (list, tuple)):
            out.append(f"{pad}{key}: {_yaml_flow(v)}\n")
        else:
            out.append(f"{pad}{key}: {_yaml_scalar(v)}\n")
    return "".join(out)


def _yaml_key(k) -> str:
    k = str(k)
    plain = (k.replace("_", "a").isalnum() and k.isascii() and not k[0].isdigit()
             and k.lower() not in ("true", "false", "null", "yes", "no", "on",
                                   "off", "y", "n"))
    return k if plain else _yaml_scalar(k)


def _yaml_flow(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_yaml_key(k)}: {_yaml_flow(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_flow(x) for x in v) + "]"
    return _yaml_scalar(v)


def _coerce(old_value: Any, raw: str) -> Any:
    if isinstance(old_value, bool):
        return raw.lower() == "true"
    if isinstance(old_value, list):
        # "[100000,200000]" or a bare "100000,200000"; element type follows
        # the first existing element
        import yaml

        parsed = yaml.safe_load(raw)
        if not isinstance(parsed, list):
            parsed = [p for p in str(raw).strip("[]").split(",") if p != ""]
        if old_value:
            elem_t = type(old_value[0])
            parsed = [e if isinstance(e, elem_t) else elem_t(e)
                      for e in parsed]
        return parsed
    if old_value is not None:
        return type(old_value)(raw)
    return raw


def update_config(config: ConfigDict, unknown: List[str]) -> ConfigDict:
    """Apply `--a:b value` / `--a value` CLI overrides with type coercion."""
    for idx, arg in enumerate(unknown):
        if not arg.startswith("--"):
            continue
        if ":" in arg:
            k1, k2 = arg.replace("--", "").split(":")
            config[k1][k2] = _coerce(config[k1][k2], unknown[idx + 1])
        else:
            k = arg.replace("--", "")
            config[k] = _coerce(config[k], unknown[idx + 1])
    return config


def create_args_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None, help="Path to config file.")
    parser.add_argument("--resume_dir", type=str, default=None,
                        help="Directory of experiment to load.")
    return parser


def _inject_optional_defaults(config: ConfigDict) -> None:
    """The JAX package's two kernel-gate keys. The port reads neither (its
    CUDA path always runs its kernels); they are kept so that the configs and
    command lines written for the JAX package load unchanged, and so that a
    config loads to the same dict in both packages."""
    if "training" in config:
        config.training.setdefault("fused_samplers", False)
        config.training.setdefault("fused_nablas_vjp", True)


def load_config(args, unknown: List[str],
                base_config_path: Optional[str] = None) -> ConfigDict:
    """Overwrite sequence: CLI params > args.config > default config yaml."""
    if (args.config is None) == (args.resume_dir is None):
        raise ValueError("specify exactly one of --config or --resume_dir")

    if args.resume_dir is not None:
        if "--expname" in unknown:
            raise ValueError("--expname cannot be combined with --resume_dir")
        config = load_yaml(os.path.join(args.resume_dir, "config.yaml"))
        _inject_optional_defaults(config)
        config = update_config(config, unknown)
        config.training["exp_dir"] = args.resume_dir
    else:
        config = load_yaml(args.config, default_path=base_config_path)
        _inject_optional_defaults(config)
        config = update_config(config, unknown)
        if "exp_dir" not in config.training:
            config.training["exp_dir"] = os.path.join(
                config.training.log_root_dir, config.expname)

    other = vars(args).copy()
    other.pop("config", None)
    other.pop("resume_dir", None)
    config.update(other)
    return config


def parse_cli(base_config_path: Optional[str] = None, extra_args_fn=None,
              argv: Optional[List[str]] = None
              ) -> Tuple[ConfigDict, argparse.Namespace]:
    parser = create_args_parser()
    if extra_args_fn is not None:
        extra_args_fn(parser)
    args, unknown = parser.parse_known_args(argv)
    return load_config(args, unknown, base_config_path), args
