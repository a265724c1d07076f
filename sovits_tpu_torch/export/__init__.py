"""ONNX emission for MoeSS-ecosystem consumers (counterpart of
``sovits_tpu/export``): a self-contained protobuf writer and reader, a graph
builder, the synthesizer and diffusion builders, and a torch runtime that
loads and runs the emitted bytes for verification."""
