from repro_torch.sharding.rules import (PartitionSpec, ShardingRules,
                                        active_rules, current_rules,
                                        default_rules, maybe_constrain)

__all__ = ["PartitionSpec", "ShardingRules", "active_rules", "current_rules",
           "default_rules", "maybe_constrain"]
