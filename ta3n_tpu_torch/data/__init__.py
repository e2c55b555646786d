"""Data helpers of the port: so far the class-list reader of the serving
CLI."""
