"""What a proof of bigmem's `main(v)` states: v in its input (a u32, as its
low and high 16-bit limbs), and in its output the wrapping sum of the
array, N v mod 2^32, then the committed element p[16] = v, each as two
limbs.  N = 128,000 is the program's (`programs/bigmem.cm`) and the
configuration's ``n_elements``."""

N = 128_000


def _limbs(w: int):
    return [w & 0xFFFF, w >> 16]


def input_slots(args):
    return _limbs(int(args[0]))


def fill_sum_slots(v: int, n: int):
    """The output of ``fill_sum(v, n)``: (n v mod 2^32, v), as limbs."""
    return _limbs(n * v % (1 << 32)) + _limbs(v)


def output_slots(args):
    return fill_sum_slots(int(args[0]), N)
