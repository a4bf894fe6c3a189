"""The benchmark's CPU test fixtures (``flowbench/tests/conftest.py``) cut
each traffic mix to a test's size by its ``kind``: this gives the
``serve_gma`` kind the ``serve`` kind's cut, so a checkout-shaped copy of
the benchmark can hold the GMA cell's mix."""

from __future__ import annotations

import pytest


@pytest.fixture(autouse=True)
def _serve_gma_tiny(monkeypatch):
    from flowbench.tests import conftest

    monkeypatch.setitem(conftest.TINY, "serve_gma", conftest.TINY["serve"])
