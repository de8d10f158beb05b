"""Opcode component specifications (reference components/opcodes/* —
SURVEY.md §2.5).  One component per provable opcode, built on the
declarative DSL in `opcode_base.py`.  Debug prints (46, 47) are unproven,
as in the reference.

Conventions (matching the VM handlers in vm/vm.py exactly):
- access lists follow the handler's memory-op order;
- nonlinear write values commit a value column (see opcode_base.Write);
- conditional next_pc commits a hint column with linking constraints.
"""

from __future__ import annotations

import numpy as np

from .. import field as m31
from .opcode_base import GenericOpcodeComponent, Hint, OpcodeSpec, Read, Write

P = (1 << 31) - 1

U16 = 1 << 16


def _specs():
    S = []

    # --- felt arithmetic fp fp (opcodes 0-3) ---
    def felt_fp_fp(name, opcode, op):
        return OpcodeSpec(
            name=name, opcode=opcode,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["src0_off"], "op0"),
                Read(lambda ns: ns["fp"] + ns["src1_off"], "op1"),
                Write(
                    lambda ns: ns["fp"] + ns["dst_off"], op, "dst_prev",
                    commit_value=True, value_name="dst_val",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1,
            next_fp=None,
        )

    S.append(felt_fp_fp("store_add_fp_fp", 0, lambda ns: ns["op0"] + ns["op1"]))
    S.append(felt_fp_fp("store_sub_fp_fp", 1, lambda ns: ns["op0"] - ns["op1"]))
    S.append(felt_fp_fp("store_mul_fp_fp", 2, lambda ns: ns["op0"] * ns["op1"]))

    # div: dst = op0 * inv(op1); hint inv1; constraint op1*inv1 == 1
    def div_inv_hint(ctx):
        op1 = ctx["operands"][:, 1, 2]
        return m31.inv_np(op1)

    S.append(
        OpcodeSpec(
            name="store_div_fp_fp", opcode=3,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["src0_off"], "op0"),
                Read(lambda ns: ns["fp"] + ns["src1_off"], "op1"),
                Write(
                    lambda ns: ns["fp"] + ns["dst_off"],
                    lambda ns: ns["op0"] * ns["inv1"], "dst_prev",
                    commit_value=True, value_name="dst_val",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
            hints=[Hint("inv1", div_inv_hint)],
            constraints=lambda ns, ev, rel: ev.add_constraint(
                ns["enabler"] * (ns["op1"] * ns["inv1"] - 1)
            ),
        )
    )

    # --- felt arithmetic fp imm (4, 6) ---
    S.append(
        OpcodeSpec(
            name="store_add_fp_imm", opcode=4,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["src_off"], "op0"),
                Write(
                    lambda ns: ns["fp"] + ns["dst_off"],
                    lambda ns: ns["op0"] + ns["imm"], "dst_prev",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
        )
    )
    S.append(
        OpcodeSpec(
            name="store_mul_fp_imm", opcode=6,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["src_off"], "op0"),
                Write(
                    lambda ns: ns["fp"] + ns["dst_off"],
                    lambda ns: ns["op0"] * ns["imm"], "dst_prev",
                    commit_value=True, value_name="dst_val",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
        )
    )

    # --- assert (50) ---
    S.append(
        OpcodeSpec(
            name="assert_eq_fp_imm", opcode=50,
            accesses=[Read(lambda ns: ns["fp"] + ns["src_off"], "op0")],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
            constraints=lambda ns, ev, rel: ev.add_constraint(
                ns["enabler"] * (ns["op0"] - ns["imm"])
            ),
        )
    )

    # --- memory (8, 42, 9, 43, 44, 45) ---
    S.append(
        OpcodeSpec(
            name="store_double_deref_fp", opcode=8,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["base_off"], "base"),
                Read(lambda ns: ns["base"] + ns["imm"], "loaded"),
                Write(
                    lambda ns: ns["fp"] + ns["dst_off"],
                    lambda ns: ns["loaded"], "dst_prev",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
        )
    )
    S.append(
        OpcodeSpec(
            name="store_double_deref_fp_fp", opcode=42,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["base_off"], "base"),
                Read(lambda ns: ns["fp"] + ns["offset_off"], "off"),
                Read(lambda ns: ns["base"] + ns["off"], "loaded"),
                Write(
                    lambda ns: ns["fp"] + ns["dst_off"],
                    lambda ns: ns["loaded"], "dst_prev",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
        )
    )
    S.append(
        OpcodeSpec(
            name="store_imm", opcode=9,
            accesses=[
                Write(
                    lambda ns: ns["fp"] + ns["dst_off"],
                    lambda ns: ns["imm"], "dst_prev",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
        )
    )
    S.append(
        OpcodeSpec(
            name="store_frame_pointer", opcode=43,
            accesses=[
                Write(
                    lambda ns: ns["fp"] + ns["dst_off"],
                    lambda ns: ns["fp"] + ns["imm"], "dst_prev",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
        )
    )
    S.append(
        OpcodeSpec(
            name="store_to_double_deref_fp_imm", opcode=44,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["base_off"], "base"),
                Read(lambda ns: ns["fp"] + ns["src_off"], "srcv"),
                Write(
                    lambda ns: ns["base"] + ns["imm"],
                    lambda ns: ns["srcv"], "tgt_prev",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
        )
    )
    S.append(
        OpcodeSpec(
            name="store_to_double_deref_fp_fp", opcode=45,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["base_off"], "base"),
                Read(lambda ns: ns["fp"] + ns["offset_off"], "off"),
                Read(lambda ns: ns["fp"] + ns["src_off"], "srcv"),
                Write(
                    lambda ns: ns["base"] + ns["off"],
                    lambda ns: ns["srcv"], "tgt_prev",
                ),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
        )
    )

    # --- call / ret (10, 11) ---
    S.append(
        OpcodeSpec(
            name="call_abs_imm", opcode=10,
            accesses=[
                Write(
                    lambda ns: ns["fp"] + ns["frame_off"],
                    lambda ns: ns["fp"], "save_fp_prev",
                ),
                Write(
                    lambda ns: ns["fp"] + ns["frame_off"] + 1,
                    lambda ns: ns["pc"] + 1, "save_pc_prev",
                ),
            ],
            next_pc=lambda ns: ns["target"],
            next_fp=lambda ns: ns["fp"] + ns["frame_off"] + 2,
        )
    )
    S.append(
        OpcodeSpec(
            name="ret", opcode=11,
            accesses=[
                Read(lambda ns: ns["fp"] - 1, "ret_pc"),
                Read(lambda ns: ns["fp"] - 2, "ret_fp"),
            ],
            next_pc=lambda ns: ns["ret_pc"],
            next_fp=lambda ns: ns["ret_fp"],
        )
    )

    # --- jumps (12, 13, 14) ---
    S.append(
        OpcodeSpec(
            name="jmp_abs_imm", opcode=12,
            accesses=[],
            next_pc=lambda ns: ns["target"], next_fp=None,
        )
    )
    S.append(
        OpcodeSpec(
            name="jmp_rel_imm", opcode=13,
            accesses=[],
            next_pc=lambda ns: ns["pc"] + ns["offset"], next_fp=None,
        )
    )

    # jnz: taken = (cond != 0); committed hints: taken, cond_inv, next_pc
    def jnz_taken(ctx):
        return (ctx["operands"][:, 0, 2] != 0).astype(np.uint32)

    def jnz_inv(ctx):
        cond = ctx["operands"][:, 0, 2]
        return np.where(cond == 0, 0, m31.inv_np(np.where(cond == 0, 1, cond)))

    def jnz_next_pc(ctx):
        cond = ctx["operands"][:, 0, 2]
        offset = ctx["words"][:, 2]
        return np.where(
            cond != 0, (ctx["pc"].astype(np.uint64) + offset) % P, (ctx["pc"] + 1) % P
        ).astype(np.uint32)

    def jnz_constraints(ns, ev, rel):
        en, t = ns["enabler"], ns["taken"]
        ev.add_constraint(en * t * (1 - t))
        # cond != 0 -> taken = 1 ; cond == 0 -> taken = 0
        ev.add_constraint(en * (ns["cond"] * ns["cond_inv"] - t))
        ev.add_constraint(en * ns["cond"] * (1 - t))
        # next_pc linkage
        ev.add_constraint(
            en * t * (ns["npc"] - ns["pc"] - ns["offset"])
        )
        ev.add_constraint(en * (1 - t) * (ns["npc"] - ns["pc"] - 1))

    S.append(
        OpcodeSpec(
            name="jnz_fp_imm", opcode=14,
            accesses=[Read(lambda ns: ns["fp"] + ns["cond_off"], "cond")],
            next_pc=lambda ns: ns["npc"], next_fp=None,
            hints=[
                Hint("taken", jnz_taken),
                Hint("cond_inv", jnz_inv),
                Hint("npc", jnz_next_pc),
            ],
            constraints=jnz_constraints,
        )
    )


    # ==================================================================
    # u32 family (reference u32_store_*.rs; 16-bit limb pairs at
    # [fp+off], [fp+off+1]; rc16 on limbs; 8-bit decompositions with rc8
    # for mul/div; bitwise via the Bitwise table)
    # ==================================================================

    def rc16(ns, ev, rel, expr):
        ev.add_to_relation(rel.range_check_16, -ns["enabler"], [expr])

    def rc8(ns, ev, rel, expr):
        ev.add_to_relation(rel.range_check_8, -ns["enabler"], [expr])

    def u32_read(base_name, off_field):
        """Two 16-bit limb Reads at fp+off, fp+off+1."""
        return [
            Read(lambda ns, f=off_field: ns["fp"] + ns[f], base_name + "_lo"),
            Read(lambda ns, f=off_field: ns["fp"] + ns[f] + 1, base_name + "_hi"),
        ]

    def op_u32(ctx, j):
        """Full u32 value of operand pair starting at access index j."""
        return ctx["operands"][:, j, 2].astype(np.uint64) + (
            ctx["operands"][:, j + 1, 2].astype(np.uint64) << 16
        )

    # ---- u32_store_imm (23) ----
    S.append(
        OpcodeSpec(
            name="u32_store_imm", opcode=23,
            accesses=[
                Write(lambda ns: ns["fp"] + ns["dst_off"],
                      lambda ns: ns["imm_lo"], "dst_prev_lo"),
                Write(lambda ns: ns["fp"] + ns["dst_off"] + 1,
                      lambda ns: ns["imm_hi"], "dst_prev_hi"),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
            constraints=lambda ns, ev, rel: (
                rc16(ns, ev, rel, ns["imm_lo"]),
                rc16(ns, ev, rel, ns["imm_hi"]),
            ),
        )
    )

    # ---- u32 add/sub fp fp (15, 16) ----
    def u32_addsub_fp_fp(name, opcode, is_add):
        def lo_val(ns):
            if is_add:
                return ns["op0_lo"] + ns["op1_lo"] - ns["c16"] * U16
            return ns["op0_lo"] - ns["op1_lo"] + ns["c16"] * U16

        def hi_val(ns):
            if is_add:
                return ns["op0_hi"] + ns["op1_hi"] + ns["c16"] - ns["c32"] * U16
            return ns["op0_hi"] - ns["op1_hi"] - ns["c16"] + ns["c32"] * U16

        def carry16(ctx):
            a, b = ctx["operands"][:, 0, 2], ctx["operands"][:, 2, 2]
            if is_add:
                return ((a.astype(np.uint64) + b) >> 16).astype(np.uint32)
            return (a < b).astype(np.uint32)

        def carry32(ctx):
            a, b = ctx["operands"][:, 1, 2], ctx["operands"][:, 3, 2]
            c = carry16(ctx)
            if is_add:
                return ((a.astype(np.uint64) + b + c) >> 16).astype(np.uint32)
            return (a.astype(np.uint64) < b.astype(np.uint64) + c).astype(np.uint32)

        def cons(ns, ev, rel):
            en = ns["enabler"]
            ev.add_constraint(en * ns["c16"] * (1 - ns["c16"]))
            ev.add_constraint(en * ns["c32"] * (1 - ns["c32"]))
            for l in ("op0_lo", "op0_hi", "op1_lo", "op1_hi"):
                rc16(ns, ev, rel, ns[l])
            rc16(ns, ev, rel, lo_val(ns))
            rc16(ns, ev, rel, hi_val(ns))

        return OpcodeSpec(
            name=name, opcode=opcode,
            accesses=u32_read("op0", "src0_off") + u32_read("op1", "src1_off") + [
                Write(lambda ns: ns["fp"] + ns["dst_off"], lo_val, "dst_prev_lo"),
                Write(lambda ns: ns["fp"] + ns["dst_off"] + 1, hi_val, "dst_prev_hi"),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
            hints=[Hint("c16", carry16), Hint("c32", carry32)],
            constraints=cons,
        )

    S.append(u32_addsub_fp_fp("u32_store_add_fp_fp", 15, True))
    S.append(u32_addsub_fp_fp("u32_store_sub_fp_fp", 16, False))

    # ---- u32 add fp imm (19) ----
    def u32_add_fp_imm():
        def lo_val(ns):
            return ns["op0_lo"] + ns["imm_lo"] - ns["c16"] * U16

        def hi_val(ns):
            return ns["op0_hi"] + ns["imm_hi"] + ns["c16"] - ns["c32"] * U16

        def carry16(ctx):
            return (
                (ctx["operands"][:, 0, 2].astype(np.uint64) + ctx["words"][:, 2]) >> 16
            ).astype(np.uint32)

        def carry32(ctx):
            return (
                (ctx["operands"][:, 1, 2].astype(np.uint64) + ctx["words"][:, 3] + carry16(ctx)) >> 16
            ).astype(np.uint32)

        def cons(ns, ev, rel):
            en = ns["enabler"]
            ev.add_constraint(en * ns["c16"] * (1 - ns["c16"]))
            ev.add_constraint(en * ns["c32"] * (1 - ns["c32"]))
            for l in ("op0_lo", "op0_hi", "imm_lo", "imm_hi"):
                rc16(ns, ev, rel, ns[l])
            rc16(ns, ev, rel, lo_val(ns))
            rc16(ns, ev, rel, hi_val(ns))

        return OpcodeSpec(
            name="u32_store_add_fp_imm", opcode=19,
            accesses=u32_read("op0", "src_off") + [
                Write(lambda ns: ns["fp"] + ns["dst_off"], lo_val, "dst_prev_lo"),
                Write(lambda ns: ns["fp"] + ns["dst_off"] + 1, hi_val, "dst_prev_hi"),
            ],
            next_pc=lambda ns: ns["pc"] + 2, next_fp=None,
            hints=[Hint("c16", carry16), Hint("c32", carry32)],
            constraints=cons,
        )

    S.append(u32_add_fp_imm())

    # ---- u32 mul (17 fp_fp, 21 fp_imm): 8-bit limb products ----
    def split8(vals16):
        return vals16 & 0xFF, vals16 >> 8

    def u32_mul(name, opcode, with_imm):
        # hints: a0..a3, b0..b3 (8-bit operand limbs), r0..r3, k0..k3 carries
        def mk_limb_hints():
            hints = []

            def opnd_limb(j, which):
                def f(ctx, j=j, which=which):
                    v = ctx["operands"][:, j, 2]
                    return (v & 0xFF) if which == 0 else (v >> 8)

                return f

            def imm_limb(widx, which):
                def f(ctx, widx=widx, which=which):
                    v = ctx["words"][:, widx]
                    return (v & 0xFF) if which == 0 else (v >> 8)

                return f

            for k in range(4):
                j, which = divmod(k, 2)
                hints.append(Hint(f"a{k}", opnd_limb(j, which)))
            for k in range(4):
                j, which = divmod(k, 2)
                if with_imm:
                    hints.append(Hint(f"b{k}", imm_limb(2 + j, which)))
                else:
                    hints.append(Hint(f"b{k}", opnd_limb(2 + j, which)))
            return hints

        def limbs_of(ctx):
            a = op_u32(ctx, 0)
            if with_imm:
                b = ctx["words"][:, 2].astype(np.uint64) + (
                    ctx["words"][:, 3].astype(np.uint64) << 16
                )
            else:
                b = op_u32(ctx, 2)
            prod = a * b
            r = prod & 0xFFFFFFFF
            return a, b, r

        def res_hint(k):
            def f(ctx, k=k):
                _, _, r = limbs_of(ctx)
                return ((r >> (8 * k)) & 0xFF).astype(np.uint32)

            return f

        def carry_hint(k):
            def f(ctx, k=k):
                a, b, _ = limbs_of(ctx)
                al = [(a >> (8 * i)) & 0xFF for i in range(4)]
                bl = [(b >> (8 * i)) & 0xFF for i in range(4)]
                carry = np.zeros(len(a), dtype=np.uint64)
                for kk in range(k + 1):
                    tot = carry + sum(al[i] * bl[kk - i] for i in range(kk + 1))
                    carry = tot >> 8
                return carry.astype(np.uint32)

            return f

        def cons(ns, ev, rel):
            en = ns["enabler"]
            a = [ns[f"a{k}"] for k in range(4)]
            b = [ns[f"b{k}"] for k in range(4)]
            r = [ns[f"r{k}"] for k in range(4)]
            c = [ns[f"k{k}"] for k in range(4)]
            # limb product equations (reference u32_store_mul_fp_fp.rs)
            ev.add_constraint(en * (r[0] - (a[0] * b[0] - c[0] * 256)))
            ev.add_constraint(
                en * (r[1] - (a[0] * b[1] + a[1] * b[0] + c[0] - c[1] * 256))
            )
            ev.add_constraint(
                en
                * (
                    r[2]
                    - (a[0] * b[2] + a[1] * b[1] + a[2] * b[0] + c[1] - c[2] * 256)
                )
            )
            ev.add_constraint(
                en
                * (
                    r[3]
                    - (
                        a[0] * b[3] + a[1] * b[2] + a[2] * b[1] + a[3] * b[0]
                        + c[2] - c[3] * 256
                    )
                )
            )
            # operand limbs tie to the 16-bit read values / imm fields
            ev.add_constraint(en * (ns["op0_lo"] - a[0] - a[1] * 256))
            ev.add_constraint(en * (ns["op0_hi"] - a[2] - a[3] * 256))
            if with_imm:
                ev.add_constraint(en * (ns["imm_lo"] - b[0] - b[1] * 256))
                ev.add_constraint(en * (ns["imm_hi"] - b[2] - b[3] * 256))
            else:
                ev.add_constraint(en * (ns["op1_lo"] - b[0] - b[1] * 256))
                ev.add_constraint(en * (ns["op1_hi"] - b[2] - b[3] * 256))
            for x in a + b + r:
                rc8(ns, ev, rel, x)
            for x in c:
                rc16(ns, ev, rel, x)

        reads = u32_read("op0", "src_off" if with_imm else "src0_off")
        if not with_imm:
            reads += u32_read("op1", "src1_off")
        return OpcodeSpec(
            name=name, opcode=opcode,
            accesses=reads + [
                Write(lambda ns: ns["fp"] + ns["dst_off"],
                      lambda ns: ns["r0"] + ns["r1"] * 256, "dst_prev_lo"),
                Write(lambda ns: ns["fp"] + ns["dst_off"] + 1,
                      lambda ns: ns["r2"] + ns["r3"] * 256, "dst_prev_hi"),
            ],
            next_pc=lambda ns: ns["pc"] + (2 if with_imm else 1), next_fp=None,
            hints=mk_limb_hints()
            + [Hint(f"r{k}", res_hint(k)) for k in range(4)]
            + [Hint(f"k{k}", carry_hint(k)) for k in range(4)],
            constraints=cons,
        )

    S.append(u32_mul("u32_store_mul_fp_fp", 17, False))
    S.append(u32_mul("u32_store_mul_fp_imm", 21, True))

    # ---- u32 eq (24 fp_fp, 30 fp_imm) ----
    def u32_eq(name, opcode, with_imm):
        def inv_hint(which):
            def f(ctx, which=which):
                a = ctx["operands"][:, which, 2]
                if with_imm:
                    b = ctx["words"][:, 2 + which]
                else:
                    b = ctx["operands"][:, 2 + which, 2]
                d = (b.astype(np.int64) - a.astype(np.int64)) % P
                return m31.inv_np(np.where(d == 0, 1, d).astype(np.uint32)) * (d != 0)

            return f

        def eq_hint(which):
            def f(ctx, which=which):
                a = ctx["operands"][:, which, 2]
                if with_imm:
                    b = ctx["words"][:, 2 + which]
                else:
                    b = ctx["operands"][:, 2 + which, 2]
                return (a == b).astype(np.uint32)

            return f

        def cons(ns, ev, rel):
            en = ns["enabler"]
            rhs_lo = ns["imm_lo"] if with_imm else ns["op1_lo"]
            rhs_hi = ns["imm_hi"] if with_imm else ns["op1_hi"]
            d_lo = rhs_lo - ns["op0_lo"]
            d_hi = rhs_hi - ns["op0_hi"]
            for d, e_, i_ in ((d_lo, "eq_lo", "inv_lo"), (d_hi, "eq_hi", "inv_hi")):
                ev.add_constraint(en * ns[e_] * (1 - ns[e_]))
                ev.add_constraint(en * (d * ns[i_] - (1 - ns[e_])))
                ev.add_constraint(en * d * ns[e_])

        reads = u32_read("op0", "src_off" if with_imm else "src0_off")
        if not with_imm:
            reads += u32_read("op1", "src1_off")
        return OpcodeSpec(
            name=name, opcode=opcode,
            accesses=reads + [
                Write(lambda ns: ns["fp"] + ns["dst_off"],
                      lambda ns: ns["eq_lo"] * ns["eq_hi"], "dst_prev",
                      commit_value=True, value_name="dst_val"),
            ],
            next_pc=lambda ns: ns["pc"] + (2 if with_imm else 1), next_fp=None,
            hints=[
                Hint("inv_lo", inv_hint(0)), Hint("inv_hi", inv_hint(1)),
                Hint("eq_lo", eq_hint(0)), Hint("eq_hi", eq_hint(1)),
            ],
            constraints=cons,
        )

    S.append(u32_eq("u32_store_eq_fp_fp", 24, False))
    S.append(u32_eq("u32_store_eq_fp_imm", 30, True))

    # ---- u32 lt (28 fp_fp, 34 fp_imm): borrow subtraction op1-1-op0 ----
    def u32_lt(name, opcode, with_imm):
        def borrow_hint(level):
            def f(ctx, level=level):
                a = op_u32(ctx, 0)
                if with_imm:
                    b = ctx["words"][:, 2].astype(np.uint64) + (
                        ctx["words"][:, 3].astype(np.uint64) << 16
                    )
                else:
                    b = op_u32(ctx, 2)
                # borrows of (b - 1 - a) 16-bit subtraction
                lo_ok = (b & 0xFFFF).astype(np.int64) - 1 - (a & 0xFFFF).astype(np.int64)
                b_lo = (lo_ok < 0).astype(np.uint32)
                hi_ok = (b >> 16).astype(np.int64) - b_lo - (a >> 16).astype(np.int64)
                b_hi = (hi_ok < 0).astype(np.uint32)
                return b_lo if level == 0 else b_hi

            return f

        def cons(ns, ev, rel):
            en = ns["enabler"]
            rhs_lo = ns["imm_lo"] if with_imm else ns["op1_lo"]
            rhs_hi = ns["imm_hi"] if with_imm else ns["op1_hi"]
            ev.add_constraint(en * ns["b_lo"] * (1 - ns["b_lo"]))
            ev.add_constraint(en * ns["b_hi"] * (1 - ns["b_hi"]))
            for l in ("op0_lo", "op0_hi"):
                rc16(ns, ev, rel, ns[l])
            if not with_imm:
                rc16(ns, ev, rel, ns["op1_lo"])
                rc16(ns, ev, rel, ns["op1_hi"])
            rc16(ns, ev, rel, rhs_lo - 1 + ns["b_lo"] * U16 - ns["op0_lo"])
            rc16(ns, ev, rel, rhs_hi - ns["b_lo"] + ns["b_hi"] * U16 - ns["op0_hi"])

        reads = u32_read("op0", "src_off" if with_imm else "src0_off")
        if not with_imm:
            reads += u32_read("op1", "src1_off")
        return OpcodeSpec(
            name=name, opcode=opcode,
            accesses=reads + [
                Write(lambda ns: ns["fp"] + ns["dst_off"],
                      lambda ns: 1 - ns["b_hi"], "dst_prev"),
            ],
            next_pc=lambda ns: ns["pc"] + (2 if with_imm else 1), next_fp=None,
            hints=[Hint("b_lo", borrow_hint(0)), Hint("b_hi", borrow_hint(1))],
            constraints=cons,
        )

    S.append(u32_lt("u32_store_lt_fp_fp", 28, False))
    S.append(u32_lt("u32_store_lt_fp_imm", 34, True))

    # ---- u32 bitwise (36-38 fp_fp, 39-41 fp_imm) via the Bitwise table ----
    def u32_bitwise(name, opcode, op_id, with_imm):
        pyop = [lambda a, b: a & b, lambda a, b: a | b, lambda a, b: a ^ b][op_id]

        def limb_hint(src, k):
            def f(ctx, src=src, k=k):
                if src == "a":
                    v = op_u32(ctx, 0)
                elif with_imm:
                    v = ctx["words"][:, 2].astype(np.uint64) + (
                        ctx["words"][:, 3].astype(np.uint64) << 16
                    )
                else:
                    v = op_u32(ctx, 2)
                if src == "c":
                    a = op_u32(ctx, 0)
                    if with_imm:
                        b = ctx["words"][:, 2].astype(np.uint64) + (
                            ctx["words"][:, 3].astype(np.uint64) << 16
                        )
                    else:
                        b = op_u32(ctx, 2)
                    v = pyop(a, b)
                return ((v >> (8 * k)) & 0xFF).astype(np.uint32)

            return f

        def cons(ns, ev, rel):
            en = ns["enabler"]
            a = [ns[f"a{k}"] for k in range(4)]
            c = [ns[f"c{k}"] for k in range(4)]
            b = [ns[f"b{k}"] for k in range(4)]
            ev.add_constraint(en * (ns["op0_lo"] - a[0] - a[1] * 256))
            ev.add_constraint(en * (ns["op0_hi"] - a[2] - a[3] * 256))
            if with_imm:
                ev.add_constraint(en * (ns["imm_lo"] - b[0] - b[1] * 256))
                ev.add_constraint(en * (ns["imm_hi"] - b[2] - b[3] * 256))
            else:
                ev.add_constraint(en * (ns["op1_lo"] - b[0] - b[1] * 256))
                ev.add_constraint(en * (ns["op1_hi"] - b[2] - b[3] * 256))
            opc = ev.const(op_id)
            for k in range(4):
                ev.add_to_relation(
                    rel.bitwise, -en, [opc, a[k], b[k], c[k]]
                )

        reads = u32_read("op0", "src_off" if with_imm else "src0_off")
        if not with_imm:
            reads += u32_read("op1", "src1_off")
        hints = (
            [Hint(f"a{k}", limb_hint("a", k)) for k in range(4)]
            + [Hint(f"b{k}", limb_hint("b", k)) for k in range(4)]
            + [Hint(f"c{k}", limb_hint("c", k)) for k in range(4)]
        )
        return OpcodeSpec(
            name=name, opcode=opcode,
            accesses=reads + [
                Write(lambda ns: ns["fp"] + ns["dst_off"],
                      lambda ns: ns["c0"] + ns["c1"] * 256, "dst_prev_lo"),
                Write(lambda ns: ns["fp"] + ns["dst_off"] + 1,
                      lambda ns: ns["c2"] + ns["c3"] * 256, "dst_prev_hi"),
            ],
            next_pc=lambda ns: ns["pc"] + (2 if with_imm else 1), next_fp=None,
            hints=hints,
            constraints=cons,
        )

    S.append(u32_bitwise("u32_store_and_fp_fp", 36, 0, False))
    S.append(u32_bitwise("u32_store_or_fp_fp", 37, 1, False))
    S.append(u32_bitwise("u32_store_xor_fp_fp", 38, 2, False))
    S.append(u32_bitwise("u32_store_and_fp_imm", 39, 0, True))
    S.append(u32_bitwise("u32_store_or_fp_imm", 40, 1, True))
    S.append(u32_bitwise("u32_store_xor_fp_imm", 41, 2, True))


    # ---- u32 div rem (18 fp_fp, 22 fp_imm) ----
    # Prove op0 = q*d + r with r < d via: full 8-bit limb product of q*d
    # whose >=2^32 limbs are constrained to zero, an exact add with a carry
    # bool, and a borrow subtraction for r < d (reference u32_store_div_*.rs;
    # carries rc16'd, all 8-bit limbs rc8'd).
    def u32_divrem(name, opcode, with_imm):
        def d_of(ctx):
            if with_imm:
                return ctx["words"][:, 2].astype(np.uint64) + (
                    ctx["words"][:, 3].astype(np.uint64) << 16
                )
            return op_u32(ctx, 2)

        def q_of(ctx):
            a = op_u32(ctx, 0)
            d = d_of(ctx)
            d = np.where(d == 0, 1, d)
            return a // d

        def r_of(ctx):
            a = op_u32(ctx, 0)
            d = d_of(ctx)
            d = np.where(d == 0, 1, d)
            return a % d

        def limb_hint(src, k):
            def f(ctx, src=src, k=k):
                v = {"q": q_of, "d": d_of}[src](ctx)
                return ((v >> (8 * k)) & 0xFF).astype(np.uint32)

            return f

        def r16_hint(which):
            def f(ctx, which=which):
                r = r_of(ctx)
                return ((r >> (16 * which)) & 0xFFFF).astype(np.uint32)

            return f

        def carry_hint(k):
            def f(ctx, k=k):
                q, d = q_of(ctx), d_of(ctx)
                ql = [(q >> (8 * i)) & 0xFF for i in range(4)]
                dl = [(d >> (8 * i)) & 0xFF for i in range(4)]
                carry = np.zeros(len(q), dtype=np.uint64)
                for kk in range(k + 1):
                    tot = carry + sum(
                        ql[i] * dl[kk - i]
                        for i in range(max(0, kk - 3), min(kk, 3) + 1)
                    )
                    carry = tot >> 8
                return carry.astype(np.uint32)

            return f

        def addc_hint(ctx):
            q, d, r = q_of(ctx), d_of(ctx), r_of(ctx)
            z = (q * d) & 0xFFFFFFFF
            return (((z & 0xFFFF) + (r & 0xFFFF)) >> 16).astype(np.uint32)

        def brl_hint(ctx):
            d, r = d_of(ctx), r_of(ctx)
            return (((d & 0xFFFF).astype(np.int64) - 1 - (r & 0xFFFF)) < 0).astype(
                np.uint32
            )

        def cons(ns, ev, rel):
            en = ns["enabler"]
            q = [ns[f"q{k}"] for k in range(4)]
            d = [ns[f"d{k}"] for k in range(4)]
            c = [ns[f"k{k}"] for k in range(7)]
            # z = q*d (u64) with limbs 0..3 = z0..z3, limbs 4..6 forced 0
            z = [None] * 4

            def conv(kk):
                return sum(
                    q[i] * d[kk - i]
                    for i in range(max(0, kk - 3), min(kk, 3) + 1)
                )

            ev.add_constraint(en * (ns["z0"] - (conv(0) - c[0] * 256)))
            ev.add_constraint(en * (ns["z1"] - (conv(1) + c[0] - c[1] * 256)))
            ev.add_constraint(en * (ns["z2"] - (conv(2) + c[1] - c[2] * 256)))
            ev.add_constraint(en * (ns["z3"] - (conv(3) + c[2] - c[3] * 256)))
            ev.add_constraint(en * (conv(4) + c[3] - c[4] * 256))
            ev.add_constraint(en * (conv(5) + c[4] - c[5] * 256))
            ev.add_constraint(en * (conv(6) + c[5] - c[6] * 256))
            ev.add_constraint(en * ns["k6"])
            # operand limb ties
            rhs_lo = ns["imm_lo"] if with_imm else ns["op1_lo"]
            rhs_hi = ns["imm_hi"] if with_imm else ns["op1_hi"]
            ev.add_constraint(en * (rhs_lo - d[0] - d[1] * 256))
            ev.add_constraint(en * (rhs_hi - d[2] - d[3] * 256))
            # op0 = z + r exactly (no wrap)
            z_lo = ns["z0"] + ns["z1"] * 256
            z_hi = ns["z2"] + ns["z3"] * 256
            ev.add_constraint(en * ns["addc"] * (1 - ns["addc"]))
            ev.add_constraint(
                en * (z_lo + ns["r_lo"] - ns["op0_lo"] - ns["addc"] * U16)
            )
            ev.add_constraint(en * (z_hi + ns["r_hi"] + ns["addc"] - ns["op0_hi"]))
            # r < d via borrow subtraction d-1-r with final borrow zero
            ev.add_constraint(en * ns["brl"] * (1 - ns["brl"]))
            rc16(ns, ev, rel, rhs_lo - 1 + ns["brl"] * U16 - ns["r_lo"])
            rc16(ns, ev, rel, rhs_hi - ns["brl"] - ns["r_hi"])
            # ranges
            for x in q + d + [ns[f"z{k}"] for k in range(4)]:
                rc8(ns, ev, rel, x)
            for x in c[:6]:
                rc16(ns, ev, rel, x)
            for l in ("op0_lo", "op0_hi", "r_lo", "r_hi"):
                rc16(ns, ev, rel, ns[l])

        reads = u32_read("op0", "src_off" if with_imm else "src0_off")
        if not with_imm:
            reads += u32_read("op1", "src1_off")
        return OpcodeSpec(
            name=name, opcode=opcode,
            accesses=reads + [
                Write(lambda ns: ns["fp"] + ns["dst_off"],
                      lambda ns: ns["q0"] + ns["q1"] * 256, "dq_prev_lo"),
                Write(lambda ns: ns["fp"] + ns["dst_off"] + 1,
                      lambda ns: ns["q2"] + ns["q3"] * 256, "dq_prev_hi"),
                Write(lambda ns: ns["fp"] + ns["dst_rem_off"],
                      lambda ns: ns["r_lo"], "dr_prev_lo"),
                Write(lambda ns: ns["fp"] + ns["dst_rem_off"] + 1,
                      lambda ns: ns["r_hi"], "dr_prev_hi"),
            ],
            next_pc=lambda ns: ns["pc"] + 2, next_fp=None,
            hints=(
                [Hint(f"q{k}", limb_hint("q", k)) for k in range(4)]
                + [Hint(f"d{k}", limb_hint("d", k)) for k in range(4)]
                + [Hint(f"z{k}",
                        (lambda kk: (lambda ctx: (((q_of(ctx) * d_of(ctx)) >> (8 * kk)) & 0xFF).astype(np.uint32)))(k))
                   for k in range(4)]
                + [Hint(f"k{k}", carry_hint(k)) for k in range(7)]
                + [Hint("r_lo", r16_hint(0)), Hint("r_hi", r16_hint(1)),
                   Hint("addc", addc_hint), Hint("brl", brl_hint)]
            ),
            constraints=cons,
        )

    S.append(u32_divrem("u32_store_div_rem_fp_fp", 18, False))
    S.append(u32_divrem("u32_store_div_rem_fp_imm", 22, True))

    # ---- store_le_fp_imm (48): felt <= imm via the cairo-lang arc argument
    # (reference store_le_fp_imm.rs; see its module doc for the math) ----
    PRIME_OVER_3_HIGH = (P // 3 + 1 + (1 << 16) - 1) // (1 << 16)
    PRIME_OVER_2_HIGH = (P // 2 + 1 + (1 << 16) - 1) // (1 << 16)

    def le_hints():
        def ab(ctx):
            src = ctx["operands"][:, 0, 2].astype(np.int64)
            imm = ctx["words"][:, 2].astype(np.int64)
            is_le = src <= imm
            a = np.where(is_le, src, imm)
            b = np.where(is_le, imm, src)
            return a, b, is_le

        def arcs(ctx):
            a, b, _ = ab(ctx)
            return np.stack([a, b - a, P - 1 - b])  # (3, n)

        def keep_hint(pair):
            def f(ctx, pair=pair):
                arc = arcs(ctx)
                excl = np.argmax(arc, axis=0)
                want = {(0, 1): 2, (0, 2): 1, (1, 2): 0}[pair]
                return (excl == want).astype(np.uint32)

            return f

        def arc_limb(which, part):
            def f(ctx, which=which, part=part):
                arc = arcs(ctx)
                excl = np.argmax(arc, axis=0)
                n = arc.shape[1]
                kept = np.stack(
                    [
                        np.where(excl == 0, arc[1], np.where(excl == 1, arc[0], arc[0])),
                        np.where(excl == 0, arc[2], np.where(excl == 1, arc[2], arc[1])),
                    ]
                )
                short = np.minimum(kept[0], kept[1])
                long_ = np.maximum(kept[0], kept[1])
                v = short if which == 0 else long_
                K = PRIME_OVER_3_HIGH if which == 0 else PRIME_OVER_2_HIGH
                return (v % K if part == 0 else v // K).astype(np.uint32)

            return f

        def isle_hint(ctx):
            return ab(ctx)[2].astype(np.uint32)

        return [
            Hint("keep_0_1", keep_hint((0, 1))),
            Hint("keep_0_2", keep_hint((0, 2))),
            Hint("keep_1_2", keep_hint((1, 2))),
            Hint("arc_short_lo", arc_limb(0, 0)),
            Hint("arc_short_hi", arc_limb(0, 1)),
            Hint("arc_long_lo", arc_limb(1, 0)),
            Hint("arc_long_hi", arc_limb(1, 1)),
            Hint("is_le", isle_hint),
            Hint("a_val", lambda ctx: (ab(ctx)[0] % P).astype(np.uint32)),
            Hint("b_val", lambda ctx: (ab(ctx)[1] % P).astype(np.uint32)),
        ]

    def le_cons(ns, ev, rel):
        en = ns["enabler"]
        a, b = ns["a_val"], ns["b_val"]
        k01, k02, k12 = ns["keep_0_1"], ns["keep_0_2"], ns["keep_1_2"]
        arc_short = ns["arc_short_lo"] + ns["arc_short_hi"] * PRIME_OVER_3_HIGH
        arc_long = ns["arc_long_lo"] + ns["arc_long_hi"] * PRIME_OVER_2_HIGH
        arc_sum = arc_short + arc_long
        arc_prod = arc_short * arc_long
        for k in (k01, k02, k12):
            ev.add_constraint(en * k * (1 - k))
        ev.add_constraint(en * (k01 + k02 + k12 - 1))
        ev.add_constraint(en * ns["is_le"] * (1 - ns["is_le"]))
        # arc-set equality via sum and product
        ev.add_constraint(en * k01 * (arc_sum - (a + (b - a))))
        ev.add_constraint(en * k01 * (arc_prod - a * (b - a)))
        ev.add_constraint(en * k02 * (arc_sum - (a + (P - 1) - b)))
        ev.add_constraint(en * k02 * (arc_prod - a * ((P - 1) - b)))
        ev.add_constraint(en * k12 * (arc_sum - ((b - a) + (P - 1) - b)))
        ev.add_constraint(en * k12 * (arc_prod - (b - a) * ((P - 1) - b)))
        # rebuild src/imm from a and b
        ev.add_constraint(
            en * (a - ns["is_le"] * ns["src_val"] - (1 - ns["is_le"]) * ns["imm"])
        )
        ev.add_constraint(
            en * (b - ns["is_le"] * ns["imm"] - (1 - ns["is_le"]) * ns["src_val"])
        )
        for l in ("arc_short_lo", "arc_short_hi", "arc_long_lo", "arc_long_hi"):
            rc16(ns, ev, rel, ns[l])

    S.append(
        OpcodeSpec(
            name="store_le_fp_imm", opcode=48,
            accesses=[
                Read(lambda ns: ns["fp"] + ns["src_off"], "src_val"),
                Write(lambda ns: ns["fp"] + ns["dst_off"],
                      lambda ns: ns["is_le"], "dst_prev"),
            ],
            next_pc=lambda ns: ns["pc"] + 1, next_fp=None,
            hints=le_hints(),
            constraints=le_cons,
        )
    )

    return S


_SPECS = None


def make_opcode_components(relations):
    global _SPECS
    if _SPECS is None:
        _SPECS = _specs()
    comps = [GenericOpcodeComponent(relations, sp) for sp in _SPECS]
    return sorted(comps, key=lambda c: c.spec.opcode)
