"""Typed AST nodes (reference: crates/compiler/parser AST)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class TypeExpr:
    kind: str  # felt|bool|u32|named|tuple|array|pointer|unit
    name: str = ""
    members: list = field(default_factory=list)  # tuple element TypeExprs
    element: Optional["TypeExpr"] = None  # array/pointer
    size: Optional[int] = None  # array


# --- expressions ---


@dataclass
class Expr:
    line: int = 0
    ty: object = None  # filled by semantic analysis (sem.Type)


@dataclass
class IntLit(Expr):
    value: int = 0
    is_u32: bool = False


@dataclass
class BoolLit(Expr):
    value: bool = False


@dataclass
class Name(Expr):
    ident: str = ""


@dataclass
class Unary(Expr):
    op: str = ""
    operand: Expr = None


@dataclass
class Binary(Expr):
    op: str = ""
    lhs: Expr = None
    rhs: Expr = None


@dataclass
class Call(Expr):
    func: str = ""
    args: list = field(default_factory=list)


@dataclass
class TupleLit(Expr):
    items: list = field(default_factory=list)


@dataclass
class ArrayLit(Expr):
    items: list = field(default_factory=list)


@dataclass
class StructLit(Expr):
    name: str = ""
    fields: list = field(default_factory=list)  # (name, Expr)


@dataclass
class Member(Expr):
    base: Expr = None
    field: str = ""  # field name or tuple index as string


@dataclass
class Index(Expr):
    base: Expr = None
    index: Expr = None


@dataclass
class Cast(Expr):
    operand: Expr = None
    target: TypeExpr = None


@dataclass
class NewArray(Expr):
    element: TypeExpr = None
    count: Expr = None


# --- statements ---


@dataclass
class Stmt:
    line: int = 0


@dataclass
class Let(Stmt):
    pattern: object = None  # str or list (tuple destructuring, recursively)
    annotation: Optional[TypeExpr] = None
    value: Expr = None


@dataclass
class Assign(Stmt):
    target: Expr = None  # Name | Member | Index
    value: Expr = None


@dataclass
class ExprStmt(Stmt):
    expr: Expr = None


@dataclass
class Return(Stmt):
    value: Optional[Expr] = None


@dataclass
class If(Stmt):
    cond: Expr = None
    then: list = field(default_factory=list)
    orelse: list = field(default_factory=list)


@dataclass
class While(Stmt):
    cond: Expr = None
    body: list = field(default_factory=list)


@dataclass
class For(Stmt):
    init: Stmt = None
    cond: Expr = None
    step: Stmt = None
    body: list = field(default_factory=list)


@dataclass
class Loop(Stmt):
    body: list = field(default_factory=list)


@dataclass
class Break(Stmt):
    pass


@dataclass
class Continue(Stmt):
    pass


# --- top level ---


@dataclass
class Param:
    name: str
    ty: TypeExpr


@dataclass
class FunctionDef:
    name: str
    params: list
    ret: Optional[TypeExpr]
    body: list
    line: int = 0


@dataclass
class StructDef:
    name: str
    fields: list  # (name, TypeExpr)
    line: int = 0


@dataclass
class ConstDef:
    name: str
    value: Expr
    line: int = 0


@dataclass
class UseStmt:
    path: list  # segments, e.g. ["math", "utils", "square"]
    line: int = 0


@dataclass
class Module:
    functions: list = field(default_factory=list)
    structs: list = field(default_factory=list)
    consts: list = field(default_factory=list)
    uses: list = field(default_factory=list)  # UseStmt
