"""Models of the port: GPT (serving) and ERNIE (pretraining)."""
