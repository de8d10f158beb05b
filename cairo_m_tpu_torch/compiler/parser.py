"""Recursive-descent parser (reference: crates/compiler/parser/src/parser.rs).

Grammar surface: functions, structs, top-level consts, use (accepted and
ignored for single-file builds), let with tuple destructuring, assignments,
if/else, while, C-style for, loop/break/continue, return; expressions with
standard precedence, calls, member/tuple access, indexing, struct/tuple/array
literals, `new T[n]`, `expr as T`, u32 literal suffix.
"""

from __future__ import annotations

from . import ast_nodes as A
from .lexer import Token, tokenize


class ParseError(Exception):
    pass


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.pos = 0

    # -- helpers --

    def peek(self, k=0) -> Token:
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def at(self, kind, text=None) -> bool:
        t = self.peek()
        return t.kind == kind and (text is None or t.text == text)

    def expect(self, kind, text=None) -> Token:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise ParseError(
                f"{t.line}:{t.col}: expected {text or kind}, found {t.text!r}"
            )
        return t

    def accept(self, kind, text=None):
        if self.at(kind, text):
            return self.next()
        return None

    # -- top level --

    def parse_module(self) -> A.Module:
        mod = A.Module()
        while not self.at("eof"):
            if self.at("kw", "fn"):
                mod.functions.append(self.function())
            elif self.at("kw", "struct"):
                mod.structs.append(self.struct())
            elif self.at("kw", "const"):
                mod.consts.append(self.const())
            elif self.at("kw", "use"):
                # `use path::to::item;` — recorded for project builds
                # (compiler/project.py); single-file builds ignore it
                t0 = self.next()
                segs = []
                while not self.accept("op", ";"):
                    t = self.next()
                    if t.kind in ("ident", "kw"):
                        segs.append(t.text)
                mod.uses.append(A.UseStmt(segs, t0.line))
            else:
                t = self.peek()
                raise ParseError(f"{t.line}:{t.col}: unexpected {t.text!r}")
        return mod

    def function(self) -> A.FunctionDef:
        line = self.expect("kw", "fn").line
        name = self.expect("ident").text
        self.expect("op", "(")
        params = []
        while not self.at("op", ")"):
            pname = self.expect("ident").text
            self.expect("op", ":")
            params.append(A.Param(pname, self.type_expr()))
            if not self.accept("op", ","):
                break
        self.expect("op", ")")
        ret = None
        if self.accept("op", "->"):
            ret = self.type_expr()
        body = self.block()
        return A.FunctionDef(name, params, ret, body, line)

    def struct(self) -> A.StructDef:
        line = self.expect("kw", "struct").line
        name = self.expect("ident").text
        self.expect("op", "{")
        fields = []
        while not self.at("op", "}"):
            fname = self.expect("ident").text
            self.expect("op", ":")
            fields.append((fname, self.type_expr()))
            if not self.accept("op", ","):
                break
        self.expect("op", "}")
        return A.StructDef(name, fields, line)

    def const(self) -> A.ConstDef:
        line = self.expect("kw", "const").line
        name = self.expect("ident").text
        if self.accept("op", ":"):
            self.type_expr()
        self.expect("op", "=")
        value = self.expr()
        self.expect("op", ";")
        return A.ConstDef(name, value, line)

    # -- types --

    def type_expr(self) -> A.TypeExpr:
        t = self.peek()
        if t.kind == "kw" and t.text in ("felt", "bool", "u32"):
            self.next()
            te = A.TypeExpr(t.text)
        elif self.at("op", "("):
            self.next()
            members = []
            while not self.at("op", ")"):
                members.append(self.type_expr())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            te = (
                A.TypeExpr("unit")
                if not members
                else (members[0] if len(members) == 1 else A.TypeExpr("tuple", members=members))
            )
        elif self.at("op", "["):
            self.next()
            elem = self.type_expr()
            self.expect("op", ";")
            size = int(self.expect("int").text, 0)
            self.expect("op", "]")
            te = A.TypeExpr("array", element=elem, size=size)
        elif t.kind == "ident":
            self.next()
            te = A.TypeExpr("named", name=t.text)
        else:
            raise ParseError(f"{t.line}:{t.col}: expected type, found {t.text!r}")
        while self.accept("op", "*"):
            te = A.TypeExpr("pointer", element=te)
        return te

    # -- statements --

    def block(self) -> list:
        self.expect("op", "{")
        out = []
        while not self.at("op", "}"):
            out.append(self.stmt())
        self.expect("op", "}")
        return out

    def stmt(self) -> A.Stmt:
        t = self.peek()
        if self.at("kw", "let"):
            return self.let_stmt()
        if self.at("kw", "return"):
            self.next()
            val = None if self.at("op", ";") else self.expr()
            self.expect("op", ";")
            return A.Return(line=t.line, value=val)
        if self.at("kw", "if"):
            return self.if_stmt()
        if self.at("kw", "while"):
            self.next()
            cond = self.expr()
            return A.While(line=t.line, cond=cond, body=self.block())
        if self.at("kw", "loop"):
            self.next()
            return A.Loop(line=t.line, body=self.block())
        if self.at("kw", "for"):
            self.next()
            self.expect("op", "(")
            init = self.let_stmt() if self.at("kw", "let") else self.simple_stmt(semi=True)
            cond = self.expr()
            self.expect("op", ";")
            step = self.simple_stmt(semi=False)
            self.expect("op", ")")
            return A.For(line=t.line, init=init, cond=cond, step=step, body=self.block())
        if self.at("kw", "break"):
            self.next()
            self.expect("op", ";")
            return A.Break(line=t.line)
        if self.at("kw", "continue"):
            self.next()
            self.expect("op", ";")
            return A.Continue(line=t.line)
        return self.simple_stmt(semi=True)

    def let_stmt(self) -> A.Let:
        line = self.expect("kw", "let").line

        def pattern():
            if self.accept("op", "("):
                pats = []
                while not self.at("op", ")"):
                    pats.append(pattern())
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
                return pats
            return self.expect("ident").text

        pat = pattern()
        ann = None
        if self.accept("op", ":"):
            ann = self.type_expr()
        self.expect("op", "=")
        value = self.expr()
        self.expect("op", ";")
        return A.Let(line=line, pattern=pat, annotation=ann, value=value)

    def simple_stmt(self, semi: bool) -> A.Stmt:
        line = self.peek().line
        e = self.expr()
        if self.accept("op", "="):
            value = self.expr()
            if semi:
                self.expect("op", ";")
            return A.Assign(line=line, target=e, value=value)
        if semi:
            self.expect("op", ";")
        return A.ExprStmt(line=line, expr=e)

    def if_stmt(self) -> A.If:
        line = self.expect("kw", "if").line
        cond = self.expr()
        then = self.block()
        orelse = []
        if self.accept("kw", "else"):
            if self.at("kw", "if"):
                orelse = [self.if_stmt()]
            else:
                orelse = self.block()
        return A.If(line=line, cond=cond, then=then, orelse=orelse)

    # -- expressions (precedence climbing) --

    PREC = {
        "||": 1,
        "&&": 2,
        "==": 3, "!=": 3,
        "<": 4, "<=": 4, ">": 4, ">=": 4,
        "|": 5, "^": 6, "&": 7,
        "+": 8, "-": 8,
        "*": 9, "/": 9, "%": 9,
    }

    def expr(self, min_prec=1) -> A.Expr:
        lhs = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in self.PREC and self.PREC[t.text] >= min_prec:
                op = self.next().text
                rhs = self.expr(self.PREC[op] + 1)
                lhs = A.Binary(line=t.line, op=op, lhs=lhs, rhs=rhs)
            elif t.kind == "kw" and t.text == "as":
                self.next()
                lhs = A.Cast(line=t.line, operand=lhs, target=self.type_expr())
            else:
                return lhs

    def unary(self) -> A.Expr:
        t = self.peek()
        if self.at("op", "-") or self.at("op", "!"):
            self.next()
            return A.Unary(line=t.line, op=t.text, operand=self.unary())
        return self.postfix()

    def postfix(self) -> A.Expr:
        e = self.primary()
        while True:
            if self.at("op", "."):
                self.next()
                f = self.next()
                if f.kind not in ("ident", "int"):
                    raise ParseError(f"{f.line}:{f.col}: expected member name")
                e = A.Member(line=f.line, base=e, field=f.text)
            elif self.at("op", "["):
                self.next()
                idx = self.expr()
                self.expect("op", "]")
                e = A.Index(line=e.line, base=e, index=idx)
            else:
                return e

    def primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == "int":
            self.next()
            return A.IntLit(line=t.line, value=int(t.text, 0))
        if t.kind == "u32lit":
            self.next()
            return A.IntLit(line=t.line, value=int(t.text, 0), is_u32=True)
        if self.at("kw", "true") or self.at("kw", "false"):
            self.next()
            return A.BoolLit(line=t.line, value=t.text == "true")
        if self.at("kw", "new"):
            self.next()
            elem = self.type_expr()
            self.expect("op", "[")
            count = self.expr()
            self.expect("op", "]")
            return A.NewArray(line=t.line, element=elem, count=count)
        if self.at("op", "("):
            self.next()
            items = []
            while not self.at("op", ")"):
                items.append(self.expr())
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            if len(items) == 1:
                return items[0]
            return A.TupleLit(line=t.line, items=items)
        if self.at("op", "["):
            self.next()
            items = []
            while not self.at("op", "]"):
                items.append(self.expr())
                if not self.accept("op", ","):
                    break
            self.expect("op", "]")
            return A.ArrayLit(line=t.line, items=items)
        if t.kind == "ident":
            # call, struct literal, or plain name
            if self.peek(1).kind == "op" and self.peek(1).text == "(":
                self.next()
                self.next()
                args = []
                while not self.at("op", ")"):
                    args.append(self.expr())
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
                return A.Call(line=t.line, func=t.text, args=args)
            if (
                self.peek(1).kind == "op"
                and self.peek(1).text == "{"
                and self._looks_like_struct_lit()
            ):
                self.next()
                self.next()
                fields = []
                while not self.at("op", "}"):
                    fname = self.expect("ident").text
                    self.expect("op", ":")
                    fields.append((fname, self.expr()))
                    if not self.accept("op", ","):
                        break
                self.expect("op", "}")
                return A.StructLit(line=t.line, name=t.text, fields=fields)
            self.next()
            return A.Name(line=t.line, ident=t.text)
        raise ParseError(f"{t.line}:{t.col}: unexpected {t.text!r} in expression")

    def _looks_like_struct_lit(self) -> bool:
        """Disambiguate `Name {` struct literal vs block context (e.g.
        `if x { ... }`): require `ident :` right after the brace."""
        return (
            self.peek(2).kind == "ident"
            and self.peek(3).kind == "op"
            and self.peek(3).text == ":"
        ) or (self.peek(2).kind == "op" and self.peek(2).text == "}")


def parse(src: str) -> A.Module:
    return Parser(src).parse_module()
