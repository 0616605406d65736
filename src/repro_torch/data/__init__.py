from .synthetic import DataConfig, SyntheticTokens
