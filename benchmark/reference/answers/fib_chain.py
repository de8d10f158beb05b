"""What the chain of the fibonacci loop states: the answers of
`fib_loop` (n in segment 0's input, fib(n) in the last segment's output),
and the VM steps of the whole run, 8n + 10, which its segments' clocks
add up to."""

from benchmark.reference.answers.fib_loop import input_slots, output_slots  # noqa: F401


def cycles(args):
    return 8 * int(args[0]) + 10
