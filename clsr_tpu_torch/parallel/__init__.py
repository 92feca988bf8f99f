"""The (data, model) mesh: process groups, collectives, row-sharded tables."""
