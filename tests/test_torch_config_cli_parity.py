"""The port's configs and command line held equal to the JAX package's.

Every field of ``Config()``, of each ``configs/*.json`` as each package's
``cli._load_config`` reads it, and of each ``baseline_config`` preset
must be the same in the two packages (``dataclasses.asdict``), and so
must the command line: the same subcommands, each with the same flags,
choices, defaults, actions, argument counts, types and required flags.  The
parsers are caught inside each package's ``cli.main`` as it builds them,
by patching ``argparse.ArgumentParser.parse_args``.

Three differences are deliberate and named here: ``export --platforms``
(the JAX package's StableHLO targets; the port exports a PyTorch program
for one device), ``export --out``'s default (each package's own file
format), and the port's ``--device`` on every subcommand (``cuda``
unless a caller asks for the CPU).
"""

import argparse
import dataclasses
import glob
import os

import pytest

import surfacenet_tpu.cli as jcli
import surfacenet_tpu.config as jconfig
import surfacenet_tpu_torch.cli as tcli
import surfacenet_tpu_torch.config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(ROOT, "configs", "*.json")))
# the names the JAX package's baseline_config accepts
PRESETS = ("dtu9_single", "dtu9_full", "dtu9_paper", "dtu_eval_split",
           "highres_sharded", "tanks_temples", "golden_aligned",
           "golden_fast")
SUBCOMMANDS = {"reconstruct", "reconstruct-all", "train", "train-pairnet",
               "selftest", "eval", "export", "bench"}


def _args(config=None):
    return argparse.Namespace(preset=None, config=config, set=None)


def test_default_config_matches_reference():
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(
        jconfig.Config())


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_file_matches_reference(name):
    path = os.path.join(ROOT, "configs", name)
    assert dataclasses.asdict(tcli._load_config(_args(path))) == \
        dataclasses.asdict(jcli._load_config(_args(path)))


@pytest.mark.parametrize("name", PRESETS)
def test_baseline_config_matches_reference(name):
    assert dataclasses.asdict(tconfig.baseline_config(name)) == \
        dataclasses.asdict(jconfig.baseline_config(name))


class _Caught(Exception):
    """Raised by the patched ``parse_args`` once the parser is built."""


def _parser(cli, monkeypatch):
    """The top-level parser ``cli.main`` builds."""
    caught = []

    def catch(self, args=None, namespace=None):
        caught.append(self)
        raise _Caught

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Caught):
        cli.main(["bench"])
    monkeypatch.undo()
    return caught[0]


def _tree(parser):
    """{subcommand: {flags: (action, choices, default, nargs, required,
    type)}}, help actions left out."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    tree = {}
    for name, p in sub.choices.items():
        tree[name] = {
            tuple(a.option_strings): (
                type(a).__name__,
                None if a.choices is None else tuple(a.choices),
                a.default, a.nargs, a.required,
                getattr(a.type, "__name__", a.type))
            for a in p._actions if not isinstance(a, argparse._HelpAction)}
    return tree


def test_cli_matches_reference(monkeypatch):
    ref = _tree(_parser(jcli, monkeypatch))
    got = _tree(_parser(tcli, monkeypatch))
    assert set(ref) == set(got) == SUBCOMMANDS
    # the deliberate differences
    del ref["export"][("--platforms",)]
    for flags in (ref, got):
        out = flags["export"][("--out",)]
        flags["export"][("--out",)] = out[:2] + (None,) + out[3:]
    for name, flags in got.items():
        device = flags.pop(("--device",))
        assert device == ("_StoreAction", ("cuda", "cpu"), "cuda", None,
                          False, None), name
    for name in SUBCOMMANDS:
        assert got[name] == ref[name], name
