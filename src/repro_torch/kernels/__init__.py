"""Stencil definitions, oracles, plan builders and the public ops."""
