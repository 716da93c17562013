"""The PR RDA solver and PR model selection."""
