"""Fire-compatible command-line parsing (no ``fire`` dependency).

The port's own copy of ``synthanatomy_tpu/cli.py`` (which holds no JAX;
the port imports nothing of the JAX package).

The reference exposes ``python run_vqvae.py run --flag=value`` via
Google Fire (run_vqvae.py:858-859), including Python-literal tuple
flags like ``--roi='((16,176),(16,240),(96,256))'`` (README.md:76).
This module reproduces that surface: the first positional argument
selects a command, ``--name=value`` / ``--name value`` pairs are parsed
with ``ast.literal_eval`` falling back to strings, and booleans accept
``--flag`` / ``--noflag`` / ``--flag=True`` forms.
"""

from __future__ import annotations

import ast
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["parse_value", "parse_argv", "dispatch"]


def parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        low = text.lower()
        if low == "true":
            return True
        if low == "false":
            return False
        if low in ("none", "null"):
            return None
        return text


def parse_argv(argv: Sequence[str]) -> (List[str], Dict[str, Any]):
    """Split argv into (positional commands, keyword flags)."""
    positional: List[str] = []
    kwargs: Dict[str, Any] = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            body = tok[2:]
            if "=" in body:
                name, val = body.split("=", 1)
                kwargs[name.replace("-", "_")] = parse_value(val)
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                kwargs[body.replace("-", "_")] = parse_value(argv[i + 1])
                i += 1
            elif body.startswith("no") and body[2:]:
                kwargs[body[2:].replace("-", "_")] = False
            else:
                kwargs[body.replace("-", "_")] = True
        else:
            positional.append(tok)
        i += 1
    return positional, kwargs


def dispatch(commands: Dict[str, Callable], argv: Optional[Sequence[str]] = None):
    """Fire-style dispatch: first positional selects the command,
    remaining flags become kwargs."""
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, kwargs = parse_argv(argv)
    if not positional:
        names = ", ".join(commands)
        raise SystemExit(f"usage: <command> [--flag=value ...]; commands: {names}")
    name = positional[0]
    if name not in commands:
        raise SystemExit(f"unknown command {name!r}; choices: {list(commands)}")
    return commands[name](**kwargs)
