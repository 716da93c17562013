"""Workflow stages over a Workspace directory."""
