"""Seconds from the process's start to the end of the cold job: the CUDA
context, the program compiled, the cold proof."""


def read(rec):
    return rec["setup_s"]
