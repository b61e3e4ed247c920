"""Plain float64 references of the benchmark's configurations: torch and
numpy only, nothing of the program."""
