"""Typed configuration, loading the reference's YAML schema unchanged (the
port's copy of zutis_tpu/core/config.py).

The same YAML files populate a dataclass with explicit defaults; keys the
dataclass lacks go to `extras`. `experiment_name` reproduces the
reference's run-name mangling (reference utils/utils.py:95-145) so that
checkpoint directories line up.

The card's machine has no PyYAML, so `parse_yaml` reads the subset of YAML
that the shipped `configs/*.yaml` and `yaml.safe_dump` of a config dict
use: comments, block mappings and sequences, plain, single- and
double-quoted scalars, PyYAML's YAML 1.1 resolution of plain scalars to
null, bool, int and float, and one-line flow sequences and mappings
(`[0.1, 1.0]`, `{data: 8, model: 1}`). It raises `ValueError` on anything
else (anchors, tags, block scalars, multi-line scalars, documents,
mappings inside sequences, octal, hex or sexagesimal numbers, dates) rather
than read it differently from PyYAML.
"""
from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), for plain scalars
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# what PyYAML reads as another int or float form, a date or a merge or
# value key: refused rather than read as a string
_REFUSED = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                      r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")
_TRUE = ("yes", "true", "on")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\"}
_INDICATORS = "&*!|>%@`?"


def _resolve_plain(text: str) -> Any:
    if _REFUSED.match(text):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    if text[:1] in _INDICATORS or text[:2] in ("- ", ": ") or text == "-":
        raise ValueError(f"unsupported YAML syntax {text!r}")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        return float("nan") if t == ".nan" else float(t)
    return text


class _Line:
    """One logical line: its text with the comment cut off, and a cursor."""

    def __init__(self, text: str, number: int):
        self.text, self.number, self.pos = text, number, 0

    def error(self, what: str) -> ValueError:
        return ValueError(f"line {self.number}: {what}: {self.text!r}")

    def peek(self) -> str:
        return self.text[self.pos:self.pos + 1]

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1

    def quoted(self) -> str:
        quote, out = self.peek(), []
        self.pos += 1
        while True:
            c = self.peek()
            if not c:
                raise self.error("unterminated quoted scalar")
            self.pos += 1
            if c == quote:
                if quote == "'" and self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if c == "\\" and quote == '"':
                e = self.peek()
                self.pos += 1
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in "xuU":
                    n = {"x": 2, "u": 4, "U": 8}[e]
                    out.append(chr(int(self.text[self.pos:self.pos + n], 16)))
                    self.pos += n
                else:
                    raise self.error(f"unsupported escape \\{e}")
            else:
                out.append(c)

    def scalar(self, stops: str) -> Any:
        """A quoted or plain scalar ending before one of `stops` (or, for a
        plain one, before ': ')."""
        self.skip_spaces()
        if self.peek() in ("'", '"'):
            return self.quoted()
        start = self.pos
        while self.peek() and self.peek() not in stops:
            if self.text.startswith(": ", self.pos) or self.text[self.pos:] == ":":
                break
            self.pos += 1
        text = self.text[start:self.pos].strip()
        if stops and not text:
            raise self.error("an empty entry in a flow collection")
        return _resolve_plain(text)

    def flow(self) -> Any:
        """A flow sequence or mapping, or a scalar inside one."""
        self.skip_spaces()
        c = self.peek()
        if c not in "[{":
            return self.scalar(",]}")
        close, items = "]" if c == "[" else "}", [] if c == "[" else {}
        self.pos += 1
        while True:
            self.skip_spaces()
            if self.peek() == close:
                self.pos += 1
                return items
            if c == "[":
                items.append(self.flow())
            else:
                key = self.scalar(",}")
                self.skip_spaces()
                if self.peek() != ":":
                    raise self.error("a flow mapping entry without ':'")
                self.pos += 1
                items[_key(key, self)] = self.flow()
            self.skip_spaces()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != close:
                raise self.error("unterminated flow collection")

    def value(self) -> Any:
        """The rest of the line as one value; nothing may follow it."""
        self.skip_spaces()
        got = self.flow() if self.peek() in "[{" else self.scalar("")
        self.skip_spaces()
        if self.pos != len(self.text):
            raise self.error("unexpected text after a value")
        return got


def _key(key: Any, line: _Line) -> str:
    if not isinstance(key, str) or not key:
        raise line.error("only non-empty string keys are supported")
    return key


def _strip_comment(text: str) -> str:
    """`text` without its comment: a '#' outside quotes, at the start or
    after a space."""
    quote, i = None, 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1  # skip the escaped character
            elif c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1  # '' inside single quotes
                else:
                    quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def parse_yaml(text: str) -> Any:
    """The YAML subset described in the module docstring -> Python values,
    equal to what `yaml.safe_load` gives for the same text."""
    lines: List[Tuple[int, _Line]] = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent] == "\t":
            raise ValueError(f"line {number}: a tab in the indentation")
        if indent == 0 and body.startswith(("---", "...", "%")):
            raise ValueError(f"line {number}: YAML documents and directives "
                             "are not supported")
        line = _Line(body, number)
        line.pos = indent
        lines.append((indent, line))
    if not lines:
        return None

    def is_item(line: _Line) -> bool:
        return line.text.startswith("- ", line.pos) or line.text[line.pos:] == "-"

    def block(i: int, indent: int) -> Tuple[Any, int]:
        if is_item(lines[i][1]):
            return sequence(i, indent)
        return mapping(i, indent)

    def nested(i: int, indent: int, item: bool) -> Tuple[Any, int]:
        """The block value of the entry on line i - 1, if any."""
        if i < len(lines):
            ind, line = lines[i]
            if ind > indent or (ind == indent and not item and is_item(line)):
                return block(i, ind)
        return None, i

    def mapping(i: int, indent: int) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        while i < len(lines) and lines[i][0] == indent:
            line = lines[i][1]
            if is_item(line):
                break
            key = _key(line.scalar(""), line)
            if line.peek() != ":":
                raise line.error("expected 'key: value'")
            line.pos += 1
            line.skip_spaces()
            if line.pos == len(line.text):
                out[key], i = nested(i + 1, indent, item=False)
            else:
                out[key], i = line.value(), i + 1
        if i < len(lines) and lines[i][0] > indent:
            raise lines[i][1].error("unexpected indentation")
        return out, i

    def sequence(i: int, indent: int) -> Tuple[List[Any], int]:
        out: List[Any] = []
        while i < len(lines) and lines[i][0] == indent and is_item(lines[i][1]):
            line = lines[i][1]
            line.pos += 1
            line.skip_spaces()
            if line.pos == len(line.text):
                value, i = nested(i + 1, indent, item=True)
            else:  # value() refuses a 'key: value' item
                value, i = line.value(), i + 1
            out.append(value)
        if i < len(lines) and lines[i][0] > indent:
            raise lines[i][1].error("unexpected indentation")
        return out, i

    value, i = block(0, lines[0][0])
    if i != len(lines):
        raise lines[i][1].error("unexpected indentation")
    return value


@dataclass
class Config:
    # CLI flags (reference main.py:18-26)
    p_config: str = ""
    p_state_dict: str = ""
    debug: bool = False
    seed: int = 0
    weight_ce_loss: float = 1.0
    suffix: str = ""

    # base directories
    dir_ckpt: str = "ckpt"
    dir_train_dataset: List[str] = field(default_factory=list)
    p_filename_to_image_embedding: List[str] = field(default_factory=list)
    dir_val_dataset: str = ""

    # categories: either the reference's inline list, or (shipped configs)
    # a preset name from data/category_lists.py
    n_categories: int = 0
    categories: List[str] = field(default_factory=list)
    categories_preset: str = ""
    category_to_p_images_fp: str = ""
    n_images: int = 500

    # index (training) dataset
    index_dataset_name: str = "index"
    # accepted for reference-YAML compatibility; the reference itself never
    # reads it outside its configs
    use_archive_purifier: bool = False
    train_image_size: int = 384
    ignore_index: int = 255
    scale_range: Tuple[float, float] = (0.1, 1.0)
    use_advanced_copy_paste: bool = False
    # read by nothing in the reference either
    iter_label_update: int = 0
    random_duplicate: bool = False

    # validation dataset
    dataset_name: str = "coco2017"
    split: str = "val"

    # dataloaders
    train_dataloader_kwargs: Dict[str, Any] = field(default_factory=dict)
    val_dataloader_kwargs: Dict[str, Any] = field(default_factory=dict)

    # model
    clip_arch: str = "ViT-B/16"
    encoder_type: str = "clip"
    frozen_bn: bool = True
    stop_gradient: bool = True
    # stored but never read in the reference (networks/zutis.py:45)
    decoder_image_n_dims: Optional[int] = None

    # optimisation
    n_iters: int = 20000
    iter_eval: int = 1000
    iter_log: int = 250

    # additions of the JAX package (absent from the reference's configs;
    # the defaults keep those loading unchanged)
    clip_assets_dir: str = ""      # CLIP .pt weights and BPE merges
    mesh_axes: Dict[str, int] = field(default_factory=dict)  # e.g. data/model
    compute_dtype: str = "float32"  # "bfloat16" for speed
    checkpoint_every: int = 0       # full-state checkpoints; 0 = off

    extras: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def load(cls, p_config: str, **overrides) -> "Config":
        """The config at `p_config`. As the reference's main.py:30-31
        (args.update(base_args)), the YAML wins: an override only fills a
        key the YAML does not set. Unknown keys go to `extras`."""
        with open(p_config) as f:
            raw = parse_yaml(f.read())
        if not isinstance(raw, dict):
            raise ValueError(f"{p_config}: the top level is not a mapping")
        for k, v in overrides.items():
            raw.setdefault(k, v)
        raw["p_config"] = p_config
        names = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in raw.items() if k in names})
        cfg.extras = {k: v for k, v in raw.items() if k not in names}
        if isinstance(cfg.scale_range, list):
            cfg.scale_range = tuple(cfg.scale_range)
        if cfg.categories_preset and not cfg.categories:
            from zutis_tpu_torch.data.category_lists import CATEGORY_PRESETS

            cfg.categories = list(CATEGORY_PRESETS[cfg.categories_preset])
        return cfg

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, sort_keys=True)


def experiment_name(cfg: Config) -> str:
    """The reference's run-name mangling (utils/utils.py:95-145)."""
    parts: List[str] = [
        cfg.clip_arch.lower().replace("/", "_").replace("-", "_")
        .replace("@", "_")
    ]
    if "RN" in cfg.clip_arch and cfg.frozen_bn:
        parts.append("frozen_bn")
    if cfg.dataset_name == "voc2012":
        parts.append(f"bs{cfg.train_dataloader_kwargs.get('batch_size', 8)}")
    if not cfg.stop_gradient:
        parts.append("no_sg")
    if cfg.random_duplicate:
        parts.append("rd")
    if cfg.index_dataset_name == "index":
        parts.append(f"n{cfg.n_images}")
        for p in cfg.dir_train_dataset:
            dir_name = p.split("/")[-2] if "/" in p else p
            if dir_name == "ImageNet2012":
                parts.append("imagenet")
            elif dir_name == "pass":
                parts.append("pass")
            else:
                # archives beyond the reference's two get their dir name
                parts.append(dir_name.replace("/", "_"))
    parts.append(
        f"sr{int(cfg.scale_range[0] * 100)}{int(cfg.scale_range[1] * 100)}"
    )
    if cfg.suffix:
        parts.append(cfg.suffix)
    parts.append(f"s{cfg.seed}")
    if cfg.debug:
        parts.append("debug")
    return "_".join(parts)


def checkpoint_dir(cfg: Config) -> str:
    name = experiment_name(cfg)
    if cfg.dataset_name == "imagenet-s":
        return (f"{cfg.dir_ckpt}/{cfg.dataset_name}{cfg.n_categories}/"
                f"{cfg.split}/{name}/dt")
    return f"{cfg.dir_ckpt}/{cfg.dataset_name}/{cfg.split}/{name}/dt"
