from .sharding import ShardingConfig, build_param_specs, build_cache_specs, input_specs_for
