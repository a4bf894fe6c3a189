"""Test support that ships with the package: the fault-injection harness."""
