"""Hand-assembled sample programs (used by tests and benches until the
compiler lands; mirrors reference fixtures `test_data/functions/*.cm`)."""

from __future__ import annotations

from ..isa.instruction import Instruction as I
from ..isa.program import AbiSlot, EntrypointInfo, FELT, Program, U32

P = (1 << 31) - 1


def fibonacci_loop_program() -> Program:
    """fib(n): a=0, b=1; n times (a,b) = (b, a+b); return a.

    Frame: [fp-4]=n, [fp-3]=ret slot, [fp-2]=old fp, [fp-1]=ret pc.
    """
    instrs = [
        I.make("StoreAddFpImm", src_off=P - 4, imm=0, dst_off=0),  # 0: cnt = n
        I.make("StoreImm", imm=0, dst_off=1),                      # 1: a = 0
        I.make("StoreImm", imm=1, dst_off=2),                      # 2: b = 1
        I.make("JnzFpImm", cond_off=0, offset=2),                  # 3: if cnt: goto 5
        I.make("JmpAbsImm", target=10),                            # 4: goto exit
        I.make("StoreAddFpFp", src0_off=1, src1_off=2, dst_off=3),  # 5: t = a+b
        I.make("StoreAddFpImm", src_off=2, imm=0, dst_off=1),      # 6: a = b
        I.make("StoreAddFpImm", src_off=3, imm=0, dst_off=2),      # 7: b = t
        I.make("StoreAddFpImm", src_off=0, imm=P - 1, dst_off=0),  # 8: cnt -= 1
        I.make("JmpAbsImm", target=3),                             # 9: loop
        I.make("StoreAddFpImm", src_off=1, imm=0, dst_off=P - 3),  # 10: ret slot = a
        I.make("Ret"),                                             # 11
    ]
    prog = Program.from_instructions(instrs)
    prog.entrypoints["main"] = EntrypointInfo(
        pc=0, params=[AbiSlot("n", FELT)], returns=[AbiSlot("result", FELT)]
    )
    return prog


def u32_ops_program() -> Program:
    """Exercises u32 add/mul/divrem/cmp/bitwise on an input pair; returns
    ((a+b)*3) ^ (a & b) as u32 plus (a < b) as felt."""
    instrs = [
        # M=4 arg slots, K=3 ret slots: a at [fp-9], b at [fp-7]; rets u32 at [fp-5], felt at [fp-3]
        I.make("U32StoreAddFpFp", src0_off=P - 9, src1_off=P - 7, dst_off=0),  # s = a+b
        I.make("U32StoreMulFpImm", src_off=0, imm_lo=3, imm_hi=0, dst_off=2),  # m = s*3
        I.make("U32StoreAndFpFp", src0_off=P - 9, src1_off=P - 7, dst_off=4),  # n = a&b
        I.make("U32StoreXorFpFp", src0_off=2, src1_off=4, dst_off=6),          # x = m^n
        I.make("U32StoreLtFpFp", src0_off=P - 9, src1_off=P - 7, dst_off=8),   # lt = a<b
        I.make("U32StoreAddFpImm", src_off=6, imm_lo=0, imm_hi=0, dst_off=P - 5),  # ret0 = x
        I.make("StoreAddFpImm", src_off=8, imm=0, dst_off=P - 3),              # ret1 = lt
        I.make("Ret"),
    ]
    # instruction sizes: all <= 5 M31? U32StoreAddFpImm = 1+4 = 5 words -> 2 cells!
    prog = Program.from_instructions(instrs)
    # compute pc of entry = 0; sizes handled by assembler in Program.qm31_words
    prog.entrypoints["main"] = EntrypointInfo(
        pc=0,
        params=[AbiSlot("a", U32), AbiSlot("b", U32)],
        returns=[AbiSlot("x", U32), AbiSlot("lt", FELT)],
    )
    return prog
