"""The LM substrate of the port: parameter schema, layers, the dense
decoder (training and inference) and the Mamba-2 stack (training)."""
