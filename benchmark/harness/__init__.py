"""The data-driven harness: spec (files by name), env, trace, cell."""
