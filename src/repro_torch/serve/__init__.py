"""Serving engine with HPM-scheduled prefill."""
