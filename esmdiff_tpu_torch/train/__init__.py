"""MDLM fine-tuning on the port: config, data, train state, loop."""
