"""Model definitions: configs, layers, MoE, stacks and the slot API."""
