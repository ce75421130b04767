"""Expression DSL for the Table API — scalar expressions over record
batches, evaluated as vectorized numpy over column dicts.

ref role: flink-table-api-java's ``Expressions`` /
``ApiExpressionUtils`` trees (flink-table/flink-table-api-java/.../
table/api/Expressions.java) and the planner's code generation
(flink-table-planner codegen, SURVEY §3.8) — except here "codegen" is
just numpy broadcasting over the already-columnar batch, so a compiled
expression is a plain Python closure ``dict[str, ndarray] -> ndarray``.
No Janino, no Calcite: the batch layout IS the binary row format.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np

Batch = Dict[str, np.ndarray]


class Expression:
    """Node in a scalar expression tree. Subclasses implement
    ``eval(batch) -> ndarray`` (vectorized, one value per record)."""

    def eval(self, batch: Batch) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def fields(self) -> set:
        """Column names this expression reads."""
        return set()

    # -- operator sugar (both Table API and the SQL planner build these)
    def _bin(self, op: str, other: Any, flip: bool = False) -> "Expression":
        o = other if isinstance(other, Expression) else Lit(other)
        return BinOp(op, o, self) if flip else BinOp(op, self, o)

    def __eq__(self, other):  # type: ignore[override]
        return self._bin("==", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._bin("!=", other)

    def __lt__(self, other):
        return self._bin("<", other)

    def __le__(self, other):
        return self._bin("<=", other)

    def __gt__(self, other):
        return self._bin(">", other)

    def __ge__(self, other):
        return self._bin(">=", other)

    def __add__(self, other):
        return self._bin("+", other)

    def __radd__(self, other):
        return self._bin("+", other, flip=True)

    def __sub__(self, other):
        return self._bin("-", other)

    def __rsub__(self, other):
        return self._bin("-", other, flip=True)

    def __mul__(self, other):
        return self._bin("*", other)

    def __rmul__(self, other):
        return self._bin("*", other, flip=True)

    def __truediv__(self, other):
        return self._bin("/", other)

    def __mod__(self, other):
        return self._bin("%", other)

    def __and__(self, other):
        return self._bin("and", other)

    def __or__(self, other):
        return self._bin("or", other)

    def __invert__(self):
        return UnaryOp("not", self)

    def __neg__(self):
        return UnaryOp("neg", self)

    def __hash__(self):
        return id(self)

    def alias(self, name: str) -> "Aliased":
        return Aliased(self, name)


@dataclasses.dataclass(eq=False)
class Col(Expression):
    name: str

    def eval(self, batch: Batch) -> np.ndarray:
        try:
            return batch[self.name]
        except KeyError:
            raise KeyError(
                f"column {self.name!r} not in batch (have "
                f"{sorted(batch)})") from None

    def fields(self) -> set:
        return {self.name}

    def __repr__(self):
        return f"col({self.name!r})"


@dataclasses.dataclass(eq=False)
class Lit(Expression):
    value: Any

    def eval(self, batch: Batch) -> np.ndarray:
        return self.value

    def __repr__(self):
        return f"lit({self.value!r})"


_BIN_FNS: Dict[str, Callable] = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "and": lambda a, b: np.logical_and(a, b),
    "or": lambda a, b: np.logical_or(a, b),
}


@dataclasses.dataclass(eq=False)
class BinOp(Expression):
    op: str
    left: Expression
    right: Expression

    def eval(self, batch: Batch) -> np.ndarray:
        return _BIN_FNS[self.op](self.left.eval(batch), self.right.eval(batch))

    def fields(self) -> set:
        return self.left.fields() | self.right.fields()

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(eq=False)
class UnaryOp(Expression):
    op: str
    arg: Expression

    def eval(self, batch: Batch) -> np.ndarray:
        v = self.arg.eval(batch)
        return np.logical_not(v) if self.op == "not" else -v

    def fields(self) -> set:
        return self.arg.fields()


@dataclasses.dataclass(eq=False)
class Aliased(Expression):
    expr: Expression
    name: str

    def eval(self, batch: Batch) -> np.ndarray:
        return self.expr.eval(batch)

    def fields(self) -> set:
        return self.expr.fields()


def col(name: str) -> Col:
    return Col(name)


def lit(value: Any) -> Lit:
    return Lit(value)
