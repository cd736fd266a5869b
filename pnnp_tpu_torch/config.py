"""Runfile-compatible configuration.

Loads the reference's YAML runfiles unchanged — anchors/aliases
(``dst: &base_dst`` / ``<<: *base_dst``) come free with pyyaml — and parses
the two embedded micro-DSLs (reference: SURVEY.md §5 config system):

  * ``command`` substring flags (``darkshading``, ``blc``, ``HB``, ``augv5``,
    ``alldg``, ... — reference: grep self.args['command'])
  * ``noise_code`` char DSL (``p g r q d b`` — reference: process.py:598-603)
"""

from __future__ import annotations

import os
from dataclasses import dataclass
import yaml

COMMAND_FLAGS = (
    "darkshading", "darkshading2", "++", "blc", "blc2", "nblc", "HB", "preHB",
    "lr10", "idremap", "augv2", "augv5", "alldg", "rdg", "cache", "buffer",
    "small", "small2", "small3", "limitediso", "exactiso", "lowISO", "highISO",
    "GTdn", "isp", "trainonly", "ratiofix", "hotfix",
)


@dataclass
class Command:
    """Parsed ``command`` string with substring-flag semantics preserved."""

    raw: str = ""

    def __contains__(self, flag: str) -> bool:
        return flag in self.raw

    def lower(self) -> "Command":
        return Command(self.raw.lower())

    def flags(self) -> set:
        return {f for f in COMMAND_FLAGS if f in self.raw}


@dataclass
class NoiseCode:
    """Parsed ``noise_code`` char DSL (reference: process.py:598-603)."""

    raw: str = "p"

    @property
    def shot_poisson(self):  # 'p'
        return "p" in self.raw.lower()

    @property
    def read_tukey(self):  # 'g'
        return "g" in self.raw.lower()

    @property
    def row(self):  # 'r'
        return "r" in self.raw.lower()

    @property
    def quant(self):  # 'q'
        return "q" in self.raw.lower()

    @property
    def dark_bias(self):  # 'd'
        return "d" in self.raw.lower()

    @property
    def black_mode(self):  # 'b'
        return "b" in self.raw.lower()


def load_runfile(path: str, mode: str | None = None, root_prefix: str | None = None) -> dict:
    """Load a reference-format runfile; optionally override mode and remap
    data roots (the ``get_host_with_dir`` analog, reference: base_trainer.py:58-66).
    """
    with open(path, "r", encoding="utf-8") as f:
        args = yaml.safe_load(f.read())
    if mode is not None:
        args["mode"] = mode
    if "dst" in args and "clip" not in args["dst"]:
        args["dst"]["clip"] = False
    if "dst" in args:
        args["dst"]["mode"] = args.get("mode", "train")
    if root_prefix:
        for key in args:
            if "dst" in key and isinstance(args[key], dict):
                for dirkey in ("root_dir", "bias_dir", "ds_dir"):
                    if dirkey in args[key]:
                        args[key][dirkey] = os.path.join(root_prefix, args[key][dirkey])
    return args


def command_of(dst: dict) -> Command:
    return Command(dst.get("command", "") or "")


def noise_code_of(dst: dict) -> NoiseCode:
    return NoiseCode(dst.get("noise_code", "p") or "p")
