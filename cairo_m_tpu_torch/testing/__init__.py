"""Test harnesses: the mdtest markdown-driven conformance suite."""

from .mdtest import MdTest, extract_tests, run_md_test  # noqa: F401
