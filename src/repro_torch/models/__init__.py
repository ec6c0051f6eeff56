"""The LM substrate of the port: parameter schema, layers and the dense
decoder (inference)."""
