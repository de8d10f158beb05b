"""Semantic analysis: symbol resolution + type checking/inference.

Reference: crates/compiler/semantic (scope_check, type_validator,
control_flow, literal, structural validators producing Diagnostics —
SURVEY.md §2.3).  Annotates every Expr with a resolved Type and produces a
TypedModule consumed by codegen.

Type rules (matching reference semantics):
- felt: field arithmetic (+,-,*,/), == and != only; `<=` vs integer literal;
- u32: wrapping +,-,*; /,% (div-rem); full comparisons; bitwise &,|,^;
- bool: &&, ||, ! (lowered arithmetically), ==/!=;
- `u32 as felt` asserts value < P; `felt as u32` is a compile error;
- fixed arrays pass/return by pointer (ABI call_slot_size = 1);
- integer literals adapt to felt/u32/bool context.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import ast_nodes as A

P = (1 << 31) - 1


class SemanticError(Exception):
    def __init__(self, line, msg):
        super().__init__(f"line {line}: {msg}")
        self.line = line
        self.msg = msg


@dataclass(frozen=True)
class Type:
    kind: str  # felt|bool|u32|tuple|struct|array|pointer|unit
    members: tuple = ()  # tuple: (Type,...); struct: ((name, Type),...)
    name: str = ""
    element: object = None
    size: int = 0

    # -- slot accounting (mirrors isa.program.AbiType) --

    def slots(self) -> int:
        k = self.kind
        if k in ("felt", "bool", "pointer"):
            return 1
        if k == "u32":
            return 2
        if k == "tuple":
            return sum(t.slots() for t in self.members)
        if k == "struct":
            return sum(t.slots() for _, t in self.members)
        if k == "array":
            return self.size * self.element.slots()
        if k == "unit":
            return 0
        raise ValueError(k)

    def call_slots(self) -> int:
        if self.kind == "array":
            return 1  # by pointer
        if self.kind == "tuple":
            return sum(t.call_slots() for t in self.members)
        if self.kind == "struct":
            return sum(t.call_slots() for _, t in self.members)
        return self.slots()

    def field_offset(self, name: str):
        assert self.kind == "struct"
        off = 0
        for n, t in self.members:
            if n == name:
                return off, t
            off += t.slots()
        return None

    def __str__(self):
        k = self.kind
        if k in ("felt", "bool", "u32", "unit"):
            return k
        if k == "struct":
            return self.name
        if k == "tuple":
            return "(" + ", ".join(str(t) for t in self.members) + ")"
        if k == "array":
            return f"[{self.element}; {self.size}]"
        if k == "pointer":
            return f"{self.element}*"
        return k


FELT = Type("felt")
BOOL = Type("bool")
U32 = Type("u32")
UNIT = Type("unit")


@dataclass
class FuncSig:
    name: str
    params: list  # (name, Type)
    ret: Type


@dataclass
class TypedModule:
    module: A.Module
    structs: dict  # name -> Type(struct)
    functions: dict  # name -> FuncSig
    consts: dict  # name -> int


class Analyzer:
    def __init__(self, module: A.Module):
        self.module = module
        self.structs: dict = {}
        self.functions: dict = {}
        self.consts: dict = {}

    def run(self) -> TypedModule:
        for s in self.module.structs:
            if s.name in self.structs:
                raise SemanticError(s.line, f"duplicate struct {s.name}")
            self.structs[s.name] = None  # placeholder for recursive refs
        for s in self.module.structs:
            seen_fields = set()
            for n, _ in s.fields:
                if n in seen_fields:
                    raise SemanticError(s.line, f"duplicate field {n} in struct {s.name}")
                seen_fields.add(n)
            self.structs[s.name] = Type(
                "struct",
                name=s.name,
                members=tuple((n, self.resolve(t, s.line)) for n, t in s.fields),
            )
        for c in self.module.consts:
            self.consts[c.name] = self._const_eval(c.value)
        for f in self.module.functions:
            if f.name in self.functions:
                raise SemanticError(f.line, f"duplicate function {f.name}")
            if len({p.name for p in f.params}) != len(f.params):
                raise SemanticError(f.line, f"duplicate parameter name in {f.name}")
            params = [(p.name, self.resolve(p.ty, f.line)) for p in f.params]
            ret = self.resolve(f.ret, f.line) if f.ret else UNIT
            self.functions[f.name] = FuncSig(f.name, params, ret)
        for f in self.module.functions:
            self.check_function(f)
        return TypedModule(self.module, self.structs, self.functions, self.consts)

    def run_collect(self, bag) -> TypedModule | None:
        """Validator-battery mode: accumulate one diagnostic per top-level
        item that fails (recovering past it) instead of aborting at the
        first error (reference semantic/src/validation/).  Returns the
        TypedModule when everything checked, else None."""
        try:
            for s in self.module.structs:
                if s.name in self.structs:
                    raise SemanticError(s.line, f"duplicate struct {s.name}")
                self.structs[s.name] = None
            for s in self.module.structs:
                seen_fields = set()
                for n, _ in s.fields:
                    if n in seen_fields:
                        raise SemanticError(
                            s.line, f"duplicate field {n} in struct {s.name}"
                        )
                    seen_fields.add(n)
                self.structs[s.name] = Type(
                    "struct",
                    name=s.name,
                    members=tuple(
                        (n, self.resolve(t, s.line)) for n, t in s.fields
                    ),
                )
            for c in self.module.consts:
                self.consts[c.name] = self._const_eval(c.value)
            for f in self.module.functions:
                if f.name in self.functions:
                    raise SemanticError(f.line, f"duplicate function {f.name}")
                if len({p.name for p in f.params}) != len(f.params):
                    raise SemanticError(
                        f.line, f"duplicate parameter name in {f.name}"
                    )
                params = [
                    (p.name, self.resolve(p.ty, f.line)) for p in f.params
                ]
                ret = self.resolve(f.ret, f.line) if f.ret else UNIT
                self.functions[f.name] = FuncSig(f.name, params, ret)
        except SemanticError as e:
            bag.error(e.line, e.msg)
            return None
        ok = True
        for f in self.module.functions:
            try:
                self.check_function(f)
            except SemanticError as e:
                bag.error(e.line, e.msg)
                ok = False
                continue
            ok &= self._lint_function(f, bag)
        if not ok:
            return None
        return TypedModule(self.module, self.structs, self.functions, self.consts)

    # -- validator battery (reference semantic/src/validation/) ------------

    def _lint_function(self, f: A.FunctionDef, bag) -> bool:
        """control_flow + scope lints: missing return on a fallthrough path
        (error), unreachable statements (warning), unused locals (warning).
        Returns False when an ERROR was recorded."""
        sig = self.functions[f.name]
        ok = True
        if sig.ret.kind != "unit" and not _always_returns(f.body):
            bag.error(
                f.line,
                f"missing return: not all paths of {f.name} return a value",
            )
            ok = False
        _warn_unreachable(f.body, bag)
        used: set = set()
        _collect_uses(f.body, used)
        declared: list = []
        _collect_lets(f.body, declared)
        for name, line in declared:
            if name not in used and not name.startswith("_"):
                bag.warning(line, f"unused variable {name}")
        return ok

    def resolve(self, te: A.TypeExpr, line) -> Type:
        k = te.kind
        if k in ("felt", "bool", "u32", "unit"):
            return {"felt": FELT, "bool": BOOL, "u32": U32, "unit": UNIT}[k]
        if k == "named":
            t = self.structs.get(te.name)
            if t is None:
                raise SemanticError(line, f"unknown type {te.name}")
            return t
        if k == "tuple":
            return Type("tuple", members=tuple(self.resolve(m, line) for m in te.members))
        if k == "array":
            return Type("array", element=self.resolve(te.element, line), size=te.size)
        if k == "pointer":
            return Type("pointer", element=self.resolve(te.element, line))
        raise SemanticError(line, f"bad type {k}")

    def _const_eval(self, e: A.Expr) -> int:
        if isinstance(e, A.IntLit):
            return e.value
        if isinstance(e, A.Binary):
            a, b = self._const_eval(e.lhs), self._const_eval(e.rhs)
            return {
                "+": a + b, "-": a - b, "*": a * b,
            }.get(e.op) if e.op in "+-*" else None
        if isinstance(e, A.Name) and e.ident in self.consts:
            return self.consts[e.ident]
        raise SemanticError(e.line, "unsupported const expression")

    # -- function body checking --

    def check_function(self, f: A.FunctionDef):
        sig = self.functions[f.name]
        scope = [{}]
        for name, ty in sig.params:
            scope[0][name] = ty
        self._check_block(f.body, scope, sig, in_loop=False)

    def _check_block(self, stmts, scope, sig, in_loop):
        scope.append({})
        for st in stmts:
            self._check_stmt(st, scope, sig, in_loop)
        scope.pop()

    def _lookup(self, scope, name, line) -> Type:
        for frame in reversed(scope):
            if name in frame:
                return frame[name]
        if name in self.consts:
            return FELT
        raise SemanticError(line, f"unknown variable {name}")

    def _check_stmt(self, st, scope, sig, in_loop):
        if isinstance(st, A.Let):
            want = self.resolve(st.annotation, st.line) if st.annotation else None
            vt = self.type_of(st.value, scope, expected=want)
            if want is not None and not self._compatible(want, vt):
                raise SemanticError(st.line, f"let type mismatch: {want} vs {vt}")
            self._bind_pattern(st.pattern, want or vt, scope, st.line)
        elif isinstance(st, A.Assign):
            tt = self.type_of(st.target, scope, lvalue=True)
            vt = self.type_of(st.value, scope, expected=tt)
            if not self._compatible(tt, vt):
                raise SemanticError(st.line, f"assignment type mismatch: {tt} vs {vt}")
        elif isinstance(st, A.ExprStmt):
            self.type_of(st.expr, scope)
        elif isinstance(st, A.Return):
            rt = self.type_of(st.value, scope, expected=sig.ret) if st.value else UNIT
            if not self._compatible(sig.ret, rt):
                raise SemanticError(st.line, f"return type mismatch: {sig.ret} vs {rt}")
        elif isinstance(st, A.If):
            ct = self.type_of(st.cond, scope)
            if ct.kind not in ("bool", "felt"):
                raise SemanticError(st.line, f"if condition must be bool/felt, got {ct}")
            self._check_block(st.then, scope, sig, in_loop)
            self._check_block(st.orelse, scope, sig, in_loop)
        elif isinstance(st, A.While):
            ct = self.type_of(st.cond, scope)
            if ct.kind not in ("bool", "felt"):
                raise SemanticError(st.line, "while condition must be bool/felt")
            self._check_block(st.body, scope, sig, True)
        elif isinstance(st, A.For):
            scope.append({})
            self._check_stmt(st.init, scope, sig, in_loop)
            ct = self.type_of(st.cond, scope)
            if ct.kind not in ("bool", "felt"):
                raise SemanticError(st.line, "for condition must be bool/felt")
            self._check_stmt(st.step, scope, sig, in_loop)
            self._check_block(st.body, scope, sig, True)
            scope.pop()
        elif isinstance(st, A.Loop):
            self._check_block(st.body, scope, sig, True)
        elif isinstance(st, (A.Break, A.Continue)):
            if not in_loop:
                raise SemanticError(st.line, "break/continue outside loop")
        else:
            raise SemanticError(st.line, f"bad statement {type(st).__name__}")

    def _bind_pattern(self, pat, ty: Type, scope, line):
        if isinstance(pat, str):
            scope[-1][pat] = ty
            return
        if ty.kind != "tuple" or len(ty.members) != len(pat):
            raise SemanticError(line, f"cannot destructure {ty} into {len(pat)} parts")
        for p, t in zip(pat, ty.members):
            self._bind_pattern(p, t, scope, line)

    def _compatible(self, want: Type, got: Type) -> bool:
        if want == got:
            return True
        if want.kind == got.kind == "tuple":
            return len(want.members) == len(got.members) and all(
                self._compatible(a, b) for a, b in zip(want.members, got.members)
            )
        # bools flow into felt contexts (comparison results)
        if want.kind == "felt" and got.kind == "bool":
            return True
        if want.kind == "bool" and got.kind == "felt":
            return True
        return False

    # -- expression typing --

    def type_of(self, e: A.Expr, scope, expected: Type = None, lvalue=False) -> Type:
        t = self._type_of(e, scope, expected, lvalue)
        e.ty = t
        return t

    def _type_of(self, e, scope, expected, lvalue):
        if isinstance(e, A.IntLit):
            if e.is_u32 or (expected is not None and expected.kind == "u32"):
                if not 0 <= e.value < (1 << 32):
                    raise SemanticError(e.line, "u32 literal out of range")
                return U32
            if expected is not None and expected.kind == "bool":
                if e.value not in (0, 1):
                    raise SemanticError(e.line, "bool literal must be 0/1")
                return BOOL
            if not 0 <= e.value < P:
                raise SemanticError(e.line, "felt literal out of range")
            return FELT
        if isinstance(e, A.BoolLit):
            return BOOL
        if isinstance(e, A.Name):
            return self._lookup(scope, e.ident, e.line)
        if isinstance(e, A.Unary):
            ot = self.type_of(e.operand, scope, expected=expected)
            if e.op == "-":
                if ot.kind not in ("felt", "u32"):
                    raise SemanticError(e.line, f"cannot negate {ot}")
                return ot
            if e.op == "!":
                if ot.kind not in ("bool", "felt"):
                    raise SemanticError(e.line, f"cannot apply ! to {ot}")
                return BOOL
        if isinstance(e, A.Binary):
            return self._binary_type(e, scope, expected)
        if isinstance(e, A.Call):
            sig = self.functions.get(e.func)
            if sig is None:
                raise SemanticError(e.line, f"unknown function {e.func}")
            if len(e.args) != len(sig.params):
                raise SemanticError(
                    e.line, f"{e.func} expects {len(sig.params)} args, got {len(e.args)}"
                )
            for a, (_, pt) in zip(e.args, sig.params):
                at = self.type_of(a, scope, expected=pt)
                if not self._compatible(pt, at):
                    raise SemanticError(e.line, f"argument type mismatch: {pt} vs {at}")
            return sig.ret
        if isinstance(e, A.TupleLit):
            want = (
                expected.members
                if expected is not None and expected.kind == "tuple"
                else [None] * len(e.items)
            )
            if len(want) != len(e.items):
                want = [None] * len(e.items)
            return Type(
                "tuple",
                members=tuple(
                    self.type_of(i, scope, expected=w) for i, w in zip(e.items, want)
                ),
            )
        if isinstance(e, A.ArrayLit):
            ew = expected.element if expected is not None and expected.kind == "array" else None
            ts = [self.type_of(i, scope, expected=ew) for i in e.items]
            if not ts:
                raise SemanticError(e.line, "empty array literal needs annotation")
            for t in ts[1:]:
                if not self._compatible(ts[0], t):
                    raise SemanticError(e.line, "array literal element type mismatch")
            return Type("array", element=ts[0], size=len(ts))
        if isinstance(e, A.StructLit):
            st = self.structs.get(e.name)
            if st is None:
                raise SemanticError(e.line, f"unknown struct {e.name}")
            names = [n for n, _ in e.fields]
            if len(set(names)) != len(names):
                raise SemanticError(
                    e.line, f"duplicate field in {e.name} literal"
                )
            given = dict(e.fields)
            want = {n for n, _ in st.members}
            if set(given) != want:
                missing = sorted(want - set(given))
                extra = sorted(set(given) - want)
                detail = "; ".join(
                    ([f"missing {', '.join(missing)}"] if missing else [])
                    + ([f"unknown {', '.join(extra)}"] if extra else [])
                )
                raise SemanticError(
                    e.line, f"struct {e.name} field mismatch: {detail}"
                )
            for n, ft in st.members:
                at = self.type_of(given[n], scope, expected=ft)
                if not self._compatible(ft, at):
                    raise SemanticError(e.line, f"field {n}: {ft} vs {at}")
            return st
        if isinstance(e, A.Member):
            bt = self.type_of(e.base, scope, lvalue=lvalue)
            if bt.kind == "tuple":
                idx = int(e.field)
                if idx >= len(bt.members):
                    raise SemanticError(e.line, f"tuple index {idx} out of range")
                return bt.members[idx]
            if bt.kind == "struct":
                fo = bt.field_offset(e.field)
                if fo is None:
                    raise SemanticError(e.line, f"no field {e.field} on {bt.name}")
                return fo[1]
            if bt.kind == "pointer" and bt.element.kind == "struct":
                fo = bt.element.field_offset(e.field)
                if fo is None:
                    raise SemanticError(e.line, f"no field {e.field}")
                return fo[1]
            raise SemanticError(e.line, f"cannot access member of {bt}")
        if isinstance(e, A.Index):
            bt = self.type_of(e.base, scope, lvalue=lvalue)
            it = self.type_of(e.index, scope)
            if it.kind not in ("felt", "u32"):
                raise SemanticError(e.line, f"index must be felt, got {it}")
            if bt.kind in ("array", "pointer"):
                return bt.element
            raise SemanticError(e.line, f"cannot index {bt}")
        if isinstance(e, A.Cast):
            ot = self.type_of(e.operand, scope)
            tt = self.resolve(e.target, e.line)
            if ot.kind == "u32" and tt.kind == "felt":
                return FELT
            if ot.kind == "felt" and tt.kind == "u32":
                raise SemanticError(e.line, "cannot cast felt to u32")
            if ot == tt:
                return tt
            if ot.kind == "bool" and tt.kind == "felt":
                return FELT
            raise SemanticError(e.line, f"unsupported cast {ot} as {tt}")
        if isinstance(e, A.NewArray):
            et = self.resolve(e.element, e.line)
            ct = self.type_of(e.count, scope)
            if ct.kind not in ("felt", "u32"):
                raise SemanticError(e.line, "new count must be felt")
            return Type("pointer", element=et)
        raise SemanticError(e.line, f"bad expression {type(e).__name__}")

    def _binary_type(self, e: A.Binary, scope, expected):
        op = e.op
        if op in ("&&", "||"):
            for side in (e.lhs, e.rhs):
                t = self.type_of(side, scope)
                if t.kind not in ("bool", "felt"):
                    raise SemanticError(e.line, f"logical op needs bool, got {t}")
            return BOOL
        hint = expected if expected is not None and expected.kind in ("felt", "u32") else None
        lt = self.type_of(e.lhs, scope, expected=hint)
        rt = self.type_of(e.rhs, scope, expected=lt if lt.kind in ("felt", "u32") else hint)
        if lt.kind in ("felt", "u32") and rt.kind in ("felt", "u32") and lt != rt:
            # re-type an integer-literal side to match the other
            if isinstance(e.lhs, A.IntLit) and not e.lhs.is_u32:
                lt = self.type_of(e.lhs, scope, expected=rt)
            elif isinstance(e.rhs, A.IntLit) and not e.rhs.is_u32:
                rt = self.type_of(e.rhs, scope, expected=lt)
        if op in ("+", "-", "*", "/", "%"):
            # bools coerce to felt in arithmetic (comparison results)
            if lt.kind == "bool":
                lt = FELT
            if rt.kind == "bool":
                rt = FELT
            if lt != rt:
                raise SemanticError(e.line, f"operand type mismatch: {lt} {op} {rt}")
            if lt.kind == "felt" and op == "%":
                raise SemanticError(e.line, "felt has no %")
            if lt.kind not in ("felt", "u32"):
                raise SemanticError(e.line, f"cannot {op} {lt}")
            return lt
        if op in ("==", "!="):
            if lt != rt and not self._compatible(lt, rt):
                raise SemanticError(e.line, f"cannot compare {lt} and {rt}")
            return BOOL
        if op in ("<", "<=", ">", ">="):
            if lt.kind == "u32" and rt.kind == "u32":
                return BOOL
            if lt.kind == "felt" and isinstance(e.rhs, A.IntLit) and op == "<=":
                return BOOL
            raise SemanticError(
                e.line, f"ordering comparison needs u32 operands (got {lt} {op} {rt})"
            )
        if op in ("&", "|", "^"):
            if lt.kind == "u32" and rt.kind == "u32":
                return U32
            if lt.kind == "bool" and rt.kind == "bool":
                return BOOL
            raise SemanticError(e.line, f"bitwise op needs u32, got {lt} {op} {rt}")
        raise SemanticError(e.line, f"bad operator {op}")


def _always_returns(stmts) -> bool:
    """True when every control path through the block returns (reference
    semantic/src/validation/control_flow.rs role)."""
    for st in stmts:
        if isinstance(st, A.Return):
            return True
        if isinstance(st, A.If):
            if (
                st.orelse
                and _always_returns(st.then)
                and _always_returns(st.orelse)
            ):
                return True
        elif isinstance(st, A.Loop):
            # `loop` without break only exits via return
            if not _has_break(st.body):
                return True
    return False


def _has_break(stmts) -> bool:
    for st in stmts:
        if isinstance(st, A.Break):
            return True
        if isinstance(st, A.If) and (
            _has_break(st.then) or _has_break(st.orelse)
        ):
            return True
        # breaks inside NESTED loops bind to those loops
    return False


def _terminates(st) -> bool:
    if isinstance(st, (A.Return, A.Break, A.Continue)):
        return True
    if isinstance(st, A.If):
        return bool(st.orelse) and all(
            _block_terminates(b) for b in (st.then, st.orelse)
        )
    if isinstance(st, A.Loop):
        return not _has_break(st.body)
    return False


def _block_terminates(stmts) -> bool:
    return any(_terminates(st) for st in stmts)


def _warn_unreachable(stmts, bag):
    dead = False
    for st in stmts:
        if dead:
            bag.warning(st.line, "unreachable statement")
            dead = False  # one warning per dead region
        if _terminates(st):
            dead = True
        for sub in _sub_blocks(st):
            _warn_unreachable(sub, bag)


def _sub_blocks(st):
    if isinstance(st, A.If):
        return [st.then, st.orelse]
    if isinstance(st, (A.While, A.Loop)):
        return [st.body]
    if isinstance(st, A.For):
        return [st.body]
    return []


def _collect_uses(node, out: set):
    """Every Name identifier read anywhere below `node` (statements/exprs)."""
    if isinstance(node, A.Name):
        out.add(node.ident)
    for f in getattr(node, "__dataclass_fields__", {}):
        v = getattr(node, f)
        if isinstance(v, (A.Expr, A.Stmt)):
            _collect_uses(v, out)
        elif isinstance(v, (list, tuple)):
            for item in v:
                if isinstance(item, (A.Expr, A.Stmt)):
                    _collect_uses(item, out)
                elif (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and isinstance(item[1], (A.Expr, A.Stmt))
                ):
                    _collect_uses(item[1], out)
    if isinstance(node, list):
        for item in node:
            _collect_uses(item, out)


def _collect_lets(stmts, out: list):
    for st in stmts:
        if isinstance(st, A.Let) and isinstance(st.pattern, str):
            out.append((st.pattern, st.line))
        for sub in _sub_blocks(st):
            _collect_lets(sub, out)
        if isinstance(st, A.For):
            _collect_lets([st.init], out)


def analyze(module: A.Module) -> TypedModule:
    return Analyzer(module).run()
