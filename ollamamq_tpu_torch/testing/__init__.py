"""Deterministic fault injection for the serving engine."""
