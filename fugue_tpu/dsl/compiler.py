"""Runtime DSL compiler: a textual prob-model language → staged models.

Capability parity with the reference's wasm DSL crate (reference:
crates/fugue-wasm/src/dsl.rs — a runtime parser/interpreter for a
``prob!``-subset with let-binds, sample/observe/factor, for-loops, pure
returns, arithmetic, array indexing, and a JSON data environment, folded into
real Model combinators; byte-identical addresses via make_name/make_indexed;
soft runtime errors degrade to ``factor(-inf)`` + a collected warning
(dsl.rs:1-34); ``CompiledModel::{compile, build, take_warnings}``
dsl.rs:1057-1131).

Design: the DSL compiles to an ordinary effectful model closure,
so a compiled program STAGES like any hand-written model — one discovery run,
then jit-compiled log-density array programs; the browser/runtime-eval use
case gains the full vectorized engine suite for free.

Surface syntax (one statement per ``;`` or newline)::

    let mu <- sample("mu", normal(0.0, 2.0));
    let s  <- sample("s", lognormal(0.0, 1.0));
    for i in 0..n {
        observe(("y", i), normal(mu, s), data[i]);
    }
    factor(0.0);
    return mu

- 17 distribution constructors by lowercase name (normal, uniform,
  lognormal, exponential, bernoulli, categorical, beta, gamma, binomial,
  poisson, studentt, cauchy, laplace, weibull, chisquared, inversegamma,
  discreteuniform);
- addresses: a string literal, or a tuple ``("name", i)`` → ``name#i``
  (identical escaping semantics to ``addr!``);
- the data environment binds free identifiers (scalars, arrays) at build
  time; ``x[i]`` indexes arrays;
- builtins: exp, log, sqrt, abs, pow, min, max, len, sum, mean.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import jax.numpy as jnp

from ..core import distributions as dist_mod
from ..core.address import addr
from ..core.model import factor, observe, sample
from ..errors import ErrorCode, FugueError


class DSLError(FugueError):
    """Parse/compile error in a DSL program."""


def _err(msg: str, **ctx) -> DSLError:
    return DSLError(ErrorCode.NOT_STAGEABLE, msg, ctx)


DISTRIBUTIONS = {
    "normal": dist_mod.Normal,
    "uniform": dist_mod.Uniform,
    "lognormal": dist_mod.LogNormal,
    "exponential": dist_mod.Exponential,
    "bernoulli": dist_mod.Bernoulli,
    "categorical": lambda *a: dist_mod.Categorical(probs=jnp.asarray(a[0])),
    "beta": dist_mod.Beta,
    "gamma": dist_mod.Gamma,
    "binomial": dist_mod.Binomial,
    "poisson": dist_mod.Poisson,
    "studentt": dist_mod.StudentT,
    "cauchy": dist_mod.Cauchy,
    "laplace": dist_mod.Laplace,
    "weibull": dist_mod.Weibull,
    "chisquared": dist_mod.ChiSquared,
    "inversegamma": dist_mod.InverseGamma,
    "discreteuniform": dist_mod.DiscreteUniform,
    # beyond-parity extras (core.distributions EXTRA_DISTRIBUTIONS)
    "halfnormal": dist_mod.HalfNormal,
    "halfcauchy": dist_mod.HalfCauchy,
    "geometric": dist_mod.Geometric,
    "negativebinomial": dist_mod.NegativeBinomial,
    "bernoulli_logits": dist_mod.BernoulliLogits,
}

BUILTINS = {
    "exp": jnp.exp,
    "log": jnp.log,
    "sqrt": jnp.sqrt,
    "abs": jnp.abs,
    "pow": jnp.power,
    "min": jnp.minimum,
    "max": jnp.maximum,
    "len": lambda x: jnp.shape(jnp.asarray(x))[0],
    "sum": jnp.sum,
    "mean": jnp.mean,
    "logaddexp": jnp.logaddexp,
}


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<num>\d+\.(?!\.)\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<arrow><-)
  | (?P<range>\.\.)
  | (?P<op>==|!=|<=|>=|[-+*/%(){}\[\],;<>=])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


@dataclass
class Token:
    kind: str
    value: str
    pos: int


def tokenize(src: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise _err(f"unexpected character {src[i]!r}", position=i)
        kind = m.lastgroup
        if kind != "ws":
            out.append(Token(kind, m.group(), i))
        i = m.end()
    out.append(Token("eof", "", len(src)))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Num:
    value: float


@dataclass
class Str:
    value: str


@dataclass
class Var:
    name: str


@dataclass
class BinOp:
    op: str
    left: Any
    right: Any


@dataclass
class Neg:
    operand: Any


@dataclass
class Call:
    name: str
    args: List[Any]


@dataclass
class Index:
    base: Any
    index: Any


@dataclass
class AddrExpr:
    name: str
    indices: List[Any] = field(default_factory=list)


@dataclass
class DistExpr:
    name: str
    args: List[Any]


@dataclass
class LetSample:
    var: str
    address: AddrExpr
    dist: DistExpr


@dataclass
class LetPure:
    var: str
    expr: Any


@dataclass
class Observe:
    address: AddrExpr
    dist: DistExpr
    value: Any


@dataclass
class Factor:
    expr: Any


@dataclass
class For:
    var: str
    start: Any
    stop: Any
    body: List[Any]


@dataclass
class Return:
    expr: Any


# ---------------------------------------------------------------------------
# Parser (recursive descent)
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str) -> Token:
        t = self.next()
        if t.value != value:
            raise _err(f"expected {value!r}, found {t.value!r}", position=t.pos)
        return t

    def accept(self, value: str) -> bool:
        if self.peek().value == value:
            self.next()
            return True
        return False

    # -- program ------------------------------------------------------------

    def parse_program(self) -> List[Any]:
        stmts: List[Any] = []
        while self.peek().kind != "eof":
            stmts.append(self.parse_stmt())
            self.accept(";")
        return stmts

    def parse_block(self) -> List[Any]:
        self.expect("{")
        body: List[Any] = []
        while self.peek().value != "}":
            body.append(self.parse_stmt())
            self.accept(";")
        self.expect("}")
        return body

    def parse_stmt(self) -> Any:
        t = self.peek()
        if t.value == "let":
            self.next()
            name = self.next()
            if name.kind != "ident":
                raise _err("expected identifier after let", position=name.pos)
            if self.accept("<-"):
                self.expect("sample")
                self.expect("(")
                address = self.parse_addr()
                self.expect(",")
                dist = self.parse_dist()
                self.expect(")")
                return LetSample(name.value, address, dist)
            self.expect("=")
            return LetPure(name.value, self.parse_expr())
        if t.value == "observe":
            self.next()
            self.expect("(")
            address = self.parse_addr()
            self.expect(",")
            dist = self.parse_dist()
            self.expect(",")
            value = self.parse_expr()
            self.expect(")")
            return Observe(address, dist, value)
        if t.value == "factor":
            self.next()
            self.expect("(")
            e = self.parse_expr()
            self.expect(")")
            return Factor(e)
        if t.value == "for":
            self.next()
            var = self.next()
            self.expect("in")
            start = self.parse_expr()
            self.expect("..")
            stop = self.parse_expr()
            body = self.parse_block()
            return For(var.value, start, stop, body)
        if t.value == "return":
            self.next()
            return Return(self.parse_expr())
        raise _err(f"unexpected token {t.value!r}", position=t.pos)

    def parse_addr(self) -> AddrExpr:
        t = self.peek()
        if t.kind == "str":
            self.next()
            return AddrExpr(name=t.value[1:-1])
        if t.value == "(":
            self.next()
            name = self.next()
            if name.kind != "str":
                raise _err("address tuple must start with a string", position=name.pos)
            indices = []
            while self.accept(","):
                indices.append(self.parse_expr())
            self.expect(")")
            return AddrExpr(name=name.value[1:-1], indices=indices)
        raise _err("expected address (string or tuple)", position=t.pos)

    def parse_dist(self) -> DistExpr:
        t = self.next()
        name = t.value.lower()
        if name not in DISTRIBUTIONS:
            raise _err(f"unknown distribution {t.value!r}", position=t.pos)
        self.expect("(")
        args = []
        if self.peek().value != ")":
            args.append(self.parse_expr())
            while self.accept(","):
                args.append(self.parse_expr())
        self.expect(")")
        return DistExpr(name, args)

    # -- expressions (precedence climbing) ----------------------------------

    def parse_expr(self) -> Any:
        return self.parse_cmp()

    def parse_cmp(self) -> Any:
        left = self.parse_add()
        while self.peek().value in ("<", ">", "<=", ">=", "==", "!="):
            op = self.next().value
            left = BinOp(op, left, self.parse_add())
        return left

    def parse_add(self) -> Any:
        left = self.parse_mul()
        while self.peek().value in ("+", "-"):
            op = self.next().value
            left = BinOp(op, left, self.parse_mul())
        return left

    def parse_mul(self) -> Any:
        left = self.parse_unary()
        while self.peek().value in ("*", "/", "%"):
            op = self.next().value
            left = BinOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> Any:
        if self.accept("-"):
            return Neg(self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Any:
        e = self.parse_atom()
        while self.peek().value == "[":
            self.next()
            idx = self.parse_expr()
            self.expect("]")
            e = Index(e, idx)
        return e

    def parse_atom(self) -> Any:
        t = self.next()
        if t.kind == "num":
            return Num(float(t.value))
        if t.kind == "str":
            return Str(t.value[1:-1])
        if t.value == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.kind == "ident":
            if self.peek().value == "(":
                self.next()
                args = []
                if self.peek().value != ")":
                    args.append(self.parse_expr())
                    while self.accept(","):
                        args.append(self.parse_expr())
                self.expect(")")
                return Call(t.value, args)
            return Var(t.value)
        raise _err(f"unexpected token {t.value!r} in expression", position=t.pos)


# ---------------------------------------------------------------------------
# Evaluator → effectful model closure
# ---------------------------------------------------------------------------


class CompiledModel:
    """A compiled DSL program (reference: CompiledModel, dsl.rs:1057-1131).

    ``compile(source)`` parses once; ``build(data)`` binds the data
    environment and returns a model closure suitable for ``stage`` or any
    engine. Soft runtime errors during execution degrade the trace to
    ``factor(-inf)`` plus a collected warning (dsl.rs:1-34);
    ``take_warnings()`` drains them.
    """

    def __init__(self, stmts: List[Any], source: str):
        self.stmts = stmts
        self.source = source
        self._warnings: List[str] = []

    @staticmethod
    def compile(source: str) -> "CompiledModel":
        return CompiledModel(Parser(tokenize(source)).parse_program(), source)

    def take_warnings(self) -> List[str]:
        out = self._warnings
        self._warnings = []
        return out

    def build(self, data: Optional[Dict[str, Any]] = None):
        """Bind the data environment → model closure."""
        base_env = dict(BUILTINS)
        for k, v in (data or {}).items():
            base_env[k] = jnp.asarray(v) if isinstance(v, (list, tuple)) else v

        def model():
            env = dict(base_env)
            result = None
            try:
                for stmt in self.stmts:
                    result = self._exec(stmt, env)
                    if isinstance(stmt, Return):
                        break
            except DSLError as e:
                # DSL-level runtime failures (unbound names, bad indices)
                # degrade softly (reference: dsl.rs:1-34)
                self._warnings.append(f"runtime error: {e}")
                factor(-jnp.inf)
            except FugueError:
                raise  # model-structure errors (duplicate address, ...) stay hard
            except Exception as e:  # other soft errors → -inf weight + warning
                self._warnings.append(f"runtime error: {type(e).__name__}: {e}")
                factor(-jnp.inf)
            return result

        return model

    # -- execution ----------------------------------------------------------

    def _exec(self, stmt, env):
        if isinstance(stmt, LetSample):
            a = self._eval_addr(stmt.address, env)
            d = self._eval_dist(stmt.dist, env)
            env[stmt.var] = sample(a, d)
            return None
        if isinstance(stmt, LetPure):
            env[stmt.var] = self._eval(stmt.expr, env)
            return None
        if isinstance(stmt, Observe):
            a = self._eval_addr(stmt.address, env)
            d = self._eval_dist(stmt.dist, env)
            v = self._eval(stmt.value, env)
            if d.support.kind == "boolean":
                v = jnp.asarray(v, bool)
            observe(a, d, v)
            return None
        if isinstance(stmt, Factor):
            factor(self._eval(stmt.expr, env))
            return None
        if isinstance(stmt, For):
            start = int(self._eval(stmt.start, env))
            stop = int(self._eval(stmt.stop, env))
            result = None
            for i in range(start, stop):
                env[stmt.var] = i
                for s in stmt.body:
                    result = self._exec(s, env)
            return result
        if isinstance(stmt, Return):
            return self._eval(stmt.expr, env)
        raise _err(f"unknown statement {stmt!r}")

    def _eval_addr(self, a: AddrExpr, env) -> str:
        indices = [self._eval(i, env) for i in a.indices]
        idx = []
        for v in indices:
            try:
                idx.append(int(v))
            except TypeError:
                raise _err("address index must be a concrete integer")
        return addr(a.name, *idx)

    def _eval_dist(self, d: DistExpr, env):
        args = [self._eval(a, env) for a in d.args]
        return DISTRIBUTIONS[d.name](*args)

    def _eval(self, e, env):
        if isinstance(e, Num):
            return e.value
        if isinstance(e, Str):
            return e.value
        if isinstance(e, Var):
            if e.name not in env:
                raise _err(f"unbound identifier {e.name!r}")
            return env[e.name]
        if isinstance(e, Neg):
            return -self._eval(e.operand, env)
        if isinstance(e, BinOp):
            l = self._eval(e.left, env)
            r = self._eval(e.right, env)
            if e.op == "+":
                return l + r
            if e.op == "-":
                return l - r
            if e.op == "*":
                return l * r
            if e.op == "/":
                return l / r
            if e.op == "%":
                return l % r
            if e.op == "<":
                return l < r
            if e.op == ">":
                return l > r
            if e.op == "<=":
                return l <= r
            if e.op == ">=":
                return l >= r
            if e.op == "==":
                return l == r
            if e.op == "!=":
                return l != r
        if isinstance(e, Call):
            if e.name not in env or not callable(env[e.name]):
                raise _err(f"unknown function {e.name!r}")
            return env[e.name](*[self._eval(a, env) for a in e.args])
        if isinstance(e, Index):
            base = self._eval(e.base, env)
            idx = self._eval(e.index, env)
            return jnp.asarray(base)[int(idx) if not hasattr(idx, "dtype") else idx]
        raise _err(f"unknown expression {e!r}")


def compile_model(source: str) -> CompiledModel:
    """Module-level convenience (reference: CompiledModel::compile)."""
    return CompiledModel.compile(source)
