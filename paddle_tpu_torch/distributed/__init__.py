"""Distributed layer of the port: at this stage only the mp=1 fleet
layers the Llama model is built from."""
