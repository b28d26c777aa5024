"""The plain float32 PyTorch references that decide ``correct``: frozen
copies of the published models, which import nothing of the program."""
