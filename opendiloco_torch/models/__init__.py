"""Model definitions: functional Llama serving forward, configs, weight IO."""
