"""Synthesis of the benchmark's database and reads."""
