"""Test suite; tests.corpus is the seeded input generator."""
