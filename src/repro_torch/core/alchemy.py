"""The DAG vocabulary of Alchemy (counterpart of the composition half of
``repro.core.alchemy``, ``alchemy.py:223-345``): models composed in
sequence (``a > b``) and in parallel (``a | b``).

``Model`` here is a name: the compiler that turns a model's intent into
a trained pipeline is not ported, so a DAG names pipelines that a result
mapping (``{name: pipeline}``) supplies, as ``chaining.compile_dag``
takes it.

Composition is binary.  Python evaluates ``a > b > c`` as ``(a > b) and
(b > c)``; the JAX package intercepts that through a frame hook on
``Seq.__bool__``, which comes with the front end.  Until then write
``(a > b) > c``: a ``Seq`` on the left extends itself, as a ``Par`` does
with ``|``.  ``Seq.__bool__`` raises, so an unparenthesised chain fails
instead of silently keeping only its last pair.
"""

from __future__ import annotations

import dataclasses


class _Composable:
    def __gt__(self, other):              # a > b: sequential
        return Seq([self, _as_node(other)])

    def __or__(self, other):              # a | b: parallel
        return Par([self, _as_node(other)])


def _as_node(x):
    if isinstance(x, (Seq, Par, Model)):
        return x
    raise TypeError(f"cannot compose {type(x)}")


def _leaves(children) -> list:
    out = []
    for c in children:
        out += c.leaves()
    return out


def _describe(children, sep: str) -> str:
    return sep.join(f"({c.describe()})" if isinstance(c, (Seq, Par))
                    else c.name for c in children)


@dataclasses.dataclass
class Seq(_Composable):
    children: list

    def __gt__(self, other):
        return Seq(self.children + [_as_node(other)])

    def __bool__(self):
        raise TypeError("a > b > c needs parentheses in the port: write "
                        "(a > b) > c")

    def leaves(self) -> list:
        return _leaves(self.children)

    def describe(self) -> str:
        return _describe(self.children, " > ")


@dataclasses.dataclass
class Par(_Composable):
    children: list

    def __or__(self, other):
        return Par(self.children + [_as_node(other)])

    def leaves(self) -> list:
        return _leaves(self.children)

    def describe(self) -> str:
        return _describe(self.children, " | ")


class Model(_Composable):
    """One model of a DAG, by the name its pipeline has in the result."""

    def __init__(self, name: str):
        self.name = str(name)

    def leaves(self) -> list:
        return [self]

    def describe(self) -> str:
        return self.name

    def __repr__(self):
        return f"Model({self.name!r})"
