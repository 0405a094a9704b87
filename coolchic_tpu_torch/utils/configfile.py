"""ConfigArgParse-style 3-level configuration for the CLIs.

Priority (lowest to highest), matching the reference's configargparse setup
(reference cc_encode.py:36-46):

  1. the argument's declared default;
  2. a value in a config file passed via a config-source argument
     (e.g. ``--dec_cfg_residue cfg/dec/intra/hop.cfg``);
  3. an explicit command-line value.

Config files use the reference's syntax: ``key = value`` lines, ``;`` or
``#`` comments (reference cfg/dec/*/*.cfg). A config-source argument also
accepts a bare operating-point NAME (vlop/lop/mop/hop/vhop); because the
table that resolves a name depends on the frame type (intra vs residue op
points share names), resolution is a second phase -- ``parse_args`` first,
then ``apply_config`` per source once the frame type is known.

``format_values()`` reproduces configargparse's provenance dump (which the
reference writes to param.txt, cc_encode.py:387-389).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, Optional


def parse_config_file(path: str) -> Dict[str, str]:
    """``key = value`` lines; ``;``/``#`` start comments; blank lines ignored."""
    values: Dict[str, str] = {}
    with open(path) as f:
        for raw in f:
            line = raw.split(";", 1)[0].split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"{path}: bad config line {raw.rstrip()!r}")
            key, val = line.split("=", 1)
            values[key.strip().lstrip("-")] = val.strip()
    return values


class ConfigArgParser:
    """argparse wrapper with config-file middle-priority resolution."""

    def __init__(self, **kwargs):
        self._parser = argparse.ArgumentParser(**kwargs)
        self._defaults: Dict[str, Any] = {}
        self._types: Dict[str, Callable] = {}
        self._store_true: set[str] = set()
        self._provenance: Dict[str, str] = {}
        self._explicit: set[str] = set()
        self._values: Optional[argparse.Namespace] = None

    def add(self, *flags, **kwargs):
        action = self._parser.add_argument(*flags, **kwargs)
        dest = action.dest
        self._defaults[dest] = action.default
        if kwargs.get("action") == "store_true":
            self._store_true.add(dest)
        else:
            self._types[dest] = kwargs.get("type", str)
        return action

    def _coerce(self, dest: str, raw: str):
        if dest in self._store_true:
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return self._types.get(dest, str)(raw)

    def parse_args(self, argv=None) -> argparse.Namespace:
        """Phase 1: defaults + command line. Config sources are applied in
        phase 2 via apply_config()."""
        args = self._parser.parse_args(argv)

        # Which args were explicitly on the command line? Re-parse with all
        # defaults suppressed; anything present there was user-typed.
        explicit_parser = argparse.ArgumentParser(add_help=False)
        for a in self._parser._actions:
            if isinstance(a, argparse._HelpAction) or not a.option_strings:
                continue
            kw: Dict[str, Any] = {"default": argparse.SUPPRESS, "dest": a.dest}
            if isinstance(a, argparse._StoreTrueAction):
                kw["action"] = "store_true"
            elif isinstance(a, argparse._CountAction):
                kw["action"] = "count"
            elif a.nargs is not None:
                kw["nargs"] = a.nargs
            explicit_parser.add_argument(*a.option_strings, **kw)
        explicit, _ = explicit_parser.parse_known_args(argv)
        self._explicit = set(vars(explicit))

        for dest in self._defaults:
            self._provenance[dest] = ("command line" if dest in self._explicit
                                      else "default")
        self._values = args
        return args

    def apply_config(self, args: argparse.Namespace, source: str,
                     table: Optional[Dict[str, dict]] = None,
                     suffix: str = "") -> None:
        """Phase 2: overlay one config source (file path, or a name resolved
        against `table` with `suffix` appended to its keys) onto `args`,
        respecting explicit command-line values."""
        if not source:
            return
        if table is not None and source in table and not os.path.exists(source):
            # suffix per-decoder keys; table keys that exist unsuffixed
            # (e.g. warp_filter_size) pass through as-is
            file_values = {(k + suffix if (k + suffix) in self._defaults else k): v
                           for k, v in table[source].items()}
            origin = f"operating point {source!r}"
        else:
            file_values = parse_config_file(source)
            origin = f"config file {source}"
        for key, raw in file_values.items():
            if key not in self._defaults:
                raise ValueError(f"{origin}: unknown option {key!r}")
            if key in self._explicit:
                continue
            setattr(args, key, self._coerce(key, raw))
            self._provenance[key] = origin

    def format_values(self) -> str:
        """Provenance dump: one ``key: value  (source)`` line per argument
        (the reference stores configargparse's equivalent in param.txt)."""
        assert self._values is not None, "call parse_args first"
        lines = []
        for dest in sorted(self._defaults):
            val = getattr(self._values, dest, None)
            lines.append(f"{dest}: {val!r}  ({self._provenance.get(dest, 'default')})")
        return "\n".join(lines) + "\n"
