"""CRUSH: the map model, rjenkins hash and crush_ln, the exact host rule
interpreter, the text compiler, and the bulk straw2 mapper whose kernel is
``ops/csrc/crush_straw2.cu`` (torch_mapper.BulkMapper)."""
from .hash import (crush_hash32, crush_hash32_2, crush_hash32_3,
                   crush_hash32_4, crush_hash32_5, crush_hash32_2_np,
                   crush_hash32_3_np, crush_hash32_2_torch,
                   crush_hash32_3_torch)
from .ln import crush_ln, crush_ln_np, LN_TABLE
from .map import (CrushMap, Bucket, Rule, CRUSH_BUCKET_UNIFORM,
                  CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE, CRUSH_BUCKET_STRAW,
                  CRUSH_BUCKET_STRAW2, CRUSH_ITEM_NONE, CRUSH_ITEM_UNDEF,
                  CRUSH_RULE_TAKE, CRUSH_RULE_CHOOSE_FIRSTN,
                  CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_CHOOSELEAF_FIRSTN,
                  CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_EMIT,
                  OPTIMAL_TUNABLES, LEGACY_TUNABLES)
from .mapper import crush_do_rule, Workspace, is_out
from .compiler import compile_crushmap, decompile

__all__ = [
    "crush_hash32", "crush_hash32_2", "crush_hash32_3", "crush_hash32_4",
    "crush_hash32_5", "crush_hash32_2_np", "crush_hash32_3_np",
    "crush_hash32_2_torch", "crush_hash32_3_torch",
    "crush_ln", "crush_ln_np", "LN_TABLE",
    "CrushMap", "Bucket", "Rule", "CRUSH_BUCKET_UNIFORM", "CRUSH_BUCKET_LIST",
    "CRUSH_BUCKET_TREE", "CRUSH_BUCKET_STRAW", "CRUSH_BUCKET_STRAW2",
    "CRUSH_ITEM_NONE", "CRUSH_ITEM_UNDEF", "CRUSH_RULE_TAKE",
    "CRUSH_RULE_CHOOSE_FIRSTN", "CRUSH_RULE_CHOOSE_INDEP",
    "CRUSH_RULE_CHOOSELEAF_FIRSTN", "CRUSH_RULE_CHOOSELEAF_INDEP",
    "CRUSH_RULE_EMIT", "OPTIMAL_TUNABLES", "LEGACY_TUNABLES",
    "crush_do_rule", "Workspace", "is_out",
    "compile_crushmap", "decompile",
]
