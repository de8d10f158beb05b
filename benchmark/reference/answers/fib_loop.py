"""What a proof of the fibonacci loop states: the call's argument n in
its input, fib(n) over M31 (fib(0) = 0, fib(1) = 1) in its output."""

P = (1 << 31) - 1


def _fib_pair(n: int):
    """(fib(n), fib(n + 1)) mod P by fast doubling."""
    if n == 0:
        return 0, 1
    a, b = _fib_pair(n >> 1)
    c = a * ((2 * b - a) % P) % P
    d = (a * a + b * b) % P
    return (d, (c + d) % P) if n & 1 else (c, d)


def input_slots(args):
    return [int(args[0]) % P]


def output_slots(args):
    return [_fib_pair(int(args[0]))[0]]
