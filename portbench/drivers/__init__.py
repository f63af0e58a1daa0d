"""Workload drivers: each runs one kind of traffic against the program
(``traffic/<name>.json`` names its driver by ``"driver"``)."""
