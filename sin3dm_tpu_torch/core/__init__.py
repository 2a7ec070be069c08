"""Core types and host utilities of the port: Triplane, checkpoint IO, NN primitives, flags."""
