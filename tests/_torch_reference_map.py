"""Every reference test mapped to its port counterparts, or to the reason
it has none (``tests/test_torch_reference_map.py`` checks both sides).

A key is ``tests/test_<ref>.py::<test>``, a test function of the JAX
package's suite.  A value is a tuple of the port tests that hold the same
behaviour (``tests/test_torch_<x>.py::<test>``), or a string saying why
there is none:

* ``"none: ..."`` -- nothing in the port to test: a jaxpr-level audit
  (ESS003, ESS004, ESS101, ESS105, the dtype goldens), or donation, which
  the port's in-place state has no counterpart of.

No entry may read ``"none yet: ..."`` (behaviour the port has and no port
test holds): ``tests/test_torch_reference_map.py`` refuses one.
"""

MAP = {
    # tests/test_analysis.py
    'tests/test_analysis.py::test_baseline_roundtrip_and_split': (
        'tests/test_torch_analysis.py::test_baseline_roundtrip_and_split',
    ),
    'tests/test_analysis.py::test_cli_exit_codes': (
        'tests/test_torch_analysis.py::test_cli_exit_codes',
    ),
    'tests/test_analysis.py::test_disable_on_multiline_call_span': (
        'tests/test_torch_analysis.py::test_disable_on_multiline_call_span',
    ),
    'tests/test_analysis.py::test_donation_detects_undonated_program':
        'none: ESS101 (donation): no lowered program to carry aliasing attributes',
    'tests/test_analysis.py::test_donation_detects_unusable_warning':
        'none: ESS101 (donation): no lowered program to carry aliasing attributes',
    'tests/test_analysis.py::test_donation_golden_dense':
        'none: ESS101 (donation): eager torch donates nothing; the rounds update one state in place',
    'tests/test_analysis.py::test_donation_golden_paged':
        'none: ESS101 (donation): eager torch donates nothing; the rounds update one state in place',
    'tests/test_analysis.py::test_dtype_checker_flags_drift': (
        'tests/test_torch_analysis.py::test_dtype_checker_flags_drift',
    ),
    'tests/test_analysis.py::test_dtype_golden_dense':
        "none: a jaxpr dtype golden; the port holds the live state's dtypes (test_torch_analysis.py::test_state_dtypes_golden_real_session)",
    'tests/test_analysis.py::test_dtype_golden_paged':
        "none: a jaxpr dtype golden; the port holds the live state's dtypes (test_torch_analysis.py::test_state_dtypes_golden_real_session)",
    'tests/test_analysis.py::test_ess001_direct_import_and_engine_target': (
        'tests/test_torch_analysis.py::test_ess001_direct_import_and_engine_target',
    ),
    'tests/test_analysis.py::test_ess001_explicit_none_is_ok': (
        'tests/test_torch_analysis.py::test_ess001_explicit_none_is_ok',
    ),
    'tests/test_analysis.py::test_ess001_missing_slot_mask': (
        'tests/test_torch_analysis.py::test_ess001_missing_slot_mask',
    ),
    'tests/test_analysis.py::test_ess001_opaque_kwargs_stays_silent': (
        'tests/test_torch_analysis.py::test_ess001_opaque_kwargs_stays_silent',
    ),
    'tests/test_analysis.py::test_ess002_allowlisted_fetch_site': (
        'tests/test_torch_analysis.py::test_ess002_allowlisted_fetch_site',
    ),
    'tests/test_analysis.py::test_ess002_cluster_scope_and_pack_site': (
        'tests/test_torch_analysis.py::test_ess002_cluster_scope_and_pack_site',
    ),
    'tests/test_analysis.py::test_ess002_device_get_outside_fetch_site': (
        'tests/test_torch_analysis.py::test_ess002_device_get_outside_fetch_site',
    ),
    'tests/test_analysis.py::test_ess002_item_and_casts': (
        'tests/test_torch_analysis.py::test_ess002_item_and_casts',
    ),
    'tests/test_analysis.py::test_ess002_out_of_scope_module': (
        'tests/test_torch_analysis.py::test_ess002_out_of_scope_module',
    ),
    'tests/test_analysis.py::test_ess003_host_conditions_fine':
        'none: ESS003 (Python branching on traced values): eager torch traces nothing',
    'tests/test_analysis.py::test_ess003_host_function_exempt':
        'none: ESS003 (Python branching on traced values): eager torch traces nothing',
    'tests/test_analysis.py::test_ess003_if_on_traced_value':
        'none: ESS003 (Python branching on traced values): eager torch traces nothing',
    'tests/test_analysis.py::test_ess003_scoped_functions_only':
        'none: ESS003 (Python branching on traced values): eager torch traces nothing',
    'tests/test_analysis.py::test_ess003_while_and_ifexp':
        'none: ESS003 (Python branching on traced values): eager torch traces nothing',
    'tests/test_analysis.py::test_ess004_decorator_and_annotation':
        'none: ESS004 (jax.jit without donation): the port has no jit',
    'tests/test_analysis.py::test_ess004_donation_declared_ok':
        'none: ESS004 (jax.jit without donation): the port has no jit',
    'tests/test_analysis.py::test_ess004_jit_over_state_fn':
        'none: ESS004 (jax.jit without donation): the port has no jit',
    'tests/test_analysis.py::test_ess004_non_state_fn_silent':
        'none: ESS004 (jax.jit without donation): the port has no jit',
    'tests/test_analysis.py::test_fetch_audit_catches_leaky_session': (
        'tests/test_torch_analysis.py::test_fetch_audit_catches_leaky_session',
    ),
    'tests/test_analysis.py::test_fetch_checker_budget_and_total': (
        'tests/test_torch_analysis.py::test_fetch_checker_budget_and_total',
    ),
    'tests/test_analysis.py::test_fetch_golden_real_session': (
        'tests/test_torch_analysis.py::test_fetch_golden_real_session',
    ),
    'tests/test_analysis.py::test_find_big_upcasts_positive_and_threshold':
        'none: reads a jaxpr; the port has no lowered program',
    'tests/test_analysis.py::test_findings_json_shape': (
        'tests/test_torch_analysis.py::test_findings_json_shape',
    ),
    'tests/test_analysis.py::test_fingerprint_ignores_line_numbers': (
        'tests/test_torch_analysis.py::test_fingerprint_ignores_line_numbers',
    ),
    'tests/test_analysis.py::test_inline_disable_suppresses': (
        'tests/test_torch_analysis.py::test_inline_disable_suppresses',
    ),
    'tests/test_analysis.py::test_migration_pack_audit_catches_smuggled_fetch': (
        'tests/test_torch_analysis.py::test_migration_pack_audit_catches_smuggled_fetch',
    ),
    'tests/test_analysis.py::test_migration_pack_checker': (
        'tests/test_torch_analysis.py::test_migration_pack_checker',
    ),
    'tests/test_analysis.py::test_migration_pack_golden_cluster': (
        'tests/test_torch_analysis.py::test_migration_pack_golden_cluster',
    ),
    'tests/test_analysis.py::test_repo_tree_is_clean_minus_suppressions': (
        'tests/test_torch_analysis.py::test_repo_tree_is_clean_minus_suppressions',
    ),
    'tests/test_analysis.py::test_retrace_checker': (
        'tests/test_torch_analysis.py::test_capture_checker',
    ),
    'tests/test_analysis.py::test_retrace_golden_real_workload': (
        'tests/test_torch_cuda.py::test_cuda_capture_audit_one_graph_per_key',
    ),
    'tests/test_analysis.py::test_targets_cover_all_round_kinds':
        "none: the jaxpr audits' targets are lowered programs; the port has none (its rounds update one persistent state in place, checked live by ESS104)",
    # tests/test_api.py
    'tests/test_api.py::test_abort_restores_resources_and_recycled_slot_replays': (
        'tests/test_torch_api.py::test_abort_restores_resources_and_recycled_slot_replays',
    ),
    'tests/test_api.py::test_generate_stream_parity_dense_host_tier': (
        'tests/test_torch_api.py::test_generate_dense_tier_matches_reference',
    ),
    'tests/test_api.py::test_generate_stream_parity_eager': (
        'tests/test_torch_api.py::test_generate_eager_matches_reference_eager',
    ),
    'tests/test_api.py::test_generate_stream_parity_vs_run': (
        'tests/test_torch_api.py::test_generate_streams_match_reference',
    ),
    'tests/test_api.py::test_priority_admission_fifo_within_class': (
        'tests/test_torch_api.py::test_priority_admission_matches_reference',
    ),
    'tests/test_api.py::test_rejected_requests_surface_with_terminal_events': (
        'tests/test_torch_api.py::test_rejected_requests_surface_with_terminal_events',
    ),
    'tests/test_api.py::test_run_budget_exhaustion_emits_budget_terminals': (
        'tests/test_torch_api.py::test_generate_budget_ends_unfinished_with_budget',
    ),
    'tests/test_api.py::test_scheduler_abort_queued_and_running': (
        'tests/test_torch_api.py::test_scheduler_abort_queued_and_running',
    ),
    'tests/test_api.py::test_stop_token_truncates_within_spec_round': (
        'tests/test_torch_api.py::test_stop_token_inside_spec_round_matches_reference',
    ),
    'tests/test_api.py::test_stream_generator_and_latency_metrics': (
        'tests/test_torch_api.py::test_explicit_prompts_and_stream_generator',
        'tests/test_torch_api.py::test_latency_stats_match_reference',
    ),
    # tests/test_chunked_prefill.py
    'tests/test_chunked_prefill.py::test_32k_prompt_admits_without_decode_stall': (
        'tests/test_torch_chunked_prefill.py::test_32k_prompt_admits_without_decode_stall',
    ),
    'tests/test_chunked_prefill.py::test_chunked_prefill_bitwise_parity': (
        'tests/test_torch_chunked_prefill.py::test_chunked_prefill_bitwise_parity',
        'tests/test_torch_cuda.py::test_cuda_chunked_prefill_matches_oneshot',
    ),
    'tests/test_chunked_prefill.py::test_freed_slot_does_not_alias_live_slot_pages': (
        'tests/test_torch_chunked_prefill.py::test_freed_slot_does_not_alias_live_slot_pages',
        'tests/test_torch_cuda.py::test_cuda_freed_slot_does_not_alias_live_slot_pages',
    ),
    'tests/test_chunked_prefill.py::test_masked_decode_writes_nothing': (
        'tests/test_torch_chunked_prefill.py::test_masked_decode_writes_nothing',
        'tests/test_torch_cuda.py::test_cuda_masked_decode_writes_nothing',
    ),
    'tests/test_chunked_prefill.py::test_preempt_resets_generated_and_readmit_serves_full_budget': (
        'tests/test_torch_session.py::test_preempt_readmit_no_stale_pool_entries',
    ),
    'tests/test_chunked_prefill.py::test_serve_loop_freed_slot_rounds_leave_it_untouched': (
        'tests/test_torch_chunked_prefill.py::test_serve_loop_freed_slot_rounds_leave_it_untouched',
    ),
    'tests/test_chunked_prefill.py::test_serve_session_chunked_prefill_matches_oneshot_first_token': (
        'tests/test_torch_chunked_prefill.py::test_serve_session_chunked_prefill_matches_oneshot_first_token',
    ),
    'tests/test_chunked_prefill.py::test_serve_warmup_depth_independent_of_chunking': (
        'tests/test_torch_chunked_prefill.py::test_serve_warmup_depth_independent_of_chunking',
    ),
    'tests/test_chunked_prefill.py::test_serve_warmup_replays_after_last_chunk': (
        'tests/test_torch_session.py::test_serve_run_streams_match_reference',
        'tests/test_torch_slots.py::test_lru_warmup_pool_matches_reference',
    ),
    # tests/test_cluster.py
    'tests/test_cluster.py::test_abort_mid_handoff_frees_both_workers': (
        'tests/test_torch_cluster.py::test_abort_mid_handoff_frees_both_workers',
    ),
    'tests/test_cluster.py::test_channel_costmodel_delay_quantizes_to_steps': (
        'tests/test_torch_cluster.py::test_channel_costmodel_delay_quantizes_to_steps',
    ),
    'tests/test_cluster.py::test_channel_delay_order_and_cancel': (
        'tests/test_torch_cluster.py::test_channel_delay_order_and_cancel',
    ),
    'tests/test_cluster.py::test_internode_costmodel_terms': (
        'tests/test_torch_cluster.py::test_internode_costmodel_terms',
    ),
    'tests/test_cluster.py::test_migration_moves_quantized_pages_verbatim': (
        'tests/test_torch_cluster.py::test_migration_moves_quantized_pages_verbatim',
    ),
    'tests/test_cluster.py::test_pd_stream_parity_bitwise': (
        'tests/test_torch_cluster.py::test_pd_stream_parity_bitwise',
    ),
    'tests/test_cluster.py::test_pick_decode_worker_policy': (
        'tests/test_torch_cluster.py::test_pick_decode_worker_policy',
    ),
    'tests/test_cluster.py::test_preempt_on_decode_worker_replays_stream': (
        'tests/test_torch_cluster.py::test_preempt_on_decode_worker_replays_stream',
    ),
    'tests/test_cluster.py::test_router_routes_around_full_worker': (
        'tests/test_torch_cluster.py::test_router_routes_around_full_worker',
    ),
    'tests/test_cluster.py::test_wire_nbytes_skips_missing_planes': (
        'tests/test_torch_cluster.py::test_wire_nbytes_skips_missing_planes',
    ),
    # tests/test_compiled_serve.py
    'tests/test_compiled_serve.py::test_compiled_decode_round_single_device_get': (
        'tests/test_torch_session.py::test_decode_round_single_fetch',
    ),
    'tests/test_compiled_serve.py::test_compiled_eager_parity_dense_host_tier': (
        'tests/test_torch_api.py::test_generate_dense_tier_matches_reference',
        'tests/test_torch_cuda.py::test_cuda_session_graph_replay_matches_eager',
    ),
    'tests/test_compiled_serve.py::test_compiled_eager_stream_parity': (
        'tests/test_torch_mtp_session.py::test_spec_session_streams_match_reference',
        'tests/test_torch_session.py::test_serve_run_streams_match_reference',
    ),
    'tests/test_compiled_serve.py::test_compiled_spec_equals_q1_baseline': (
        'tests/test_torch_mtp_session.py::test_spec_session_streams_match_reference',
    ),
    'tests/test_compiled_serve.py::test_emit_charge_equals_delivery_at_budget_edge': (
        'tests/test_torch_mtp_session.py::test_spec_full_acceptance_and_budget_clamp',
    ),
    'tests/test_compiled_serve.py::test_max_new_tokens_one_finishes_at_promotion': (
        'tests/test_torch_session.py::test_max_new_tokens_one_finishes_at_promotion',
    ),
    'tests/test_compiled_serve.py::test_sample_batch_matches_host_sample': (
        'tests/test_torch_sampling.py::test_sample_matches_reference_small_vocab',
    ),
    'tests/test_compiled_serve.py::test_step_donates_state_no_second_host_latent':
        "none: donation; the port's rounds update the one host tier in place (no second buffer exists to check)",
    'tests/test_compiled_serve.py::test_step_programs_compile_once_per_shape_bucket': (
        'tests/test_torch_cuda.py::test_cuda_capture_audit_one_graph_per_key',
    ),
    'tests/test_compiled_serve.py::test_ttft_submit_stamp_unconditional': (
        'tests/test_torch_chunked_prefill.py::test_ttft_submit_stamp_unconditional',
    ),
    # tests/test_distributed.py
    'tests/test_distributed.py::test_compression_under_psum': (
        'tests/test_torch_distributed.py::test_compression_under_all_reduce_matches_reference',
    ),
    'tests/test_distributed.py::test_dryrun_entrypoint_small_cell': (
        'tests/test_torch_dryrun.py::test_dryrun_entrypoint_small_cell',
    ),
    'tests/test_distributed.py::test_pipeline_parallel_matches_sequential': (
        'tests/test_torch_distributed.py::test_pipeline_parallel_matches_sequential_and_reference',
    ),
    'tests/test_distributed.py::test_quantize_rows_all_zero_page_roundtrips_exactly': (
        'tests/test_torch_quant.py::test_quantize_rows_all_zero_page_roundtrips_exactly',
    ),
    'tests/test_distributed.py::test_quantize_rows_max_magnitude_clips_not_wraps': (
        'tests/test_torch_quant.py::test_quantize_rows_max_magnitude_clips_not_wraps',
    ),
    'tests/test_distributed.py::test_quantize_rows_negative_only_rows': (
        'tests/test_torch_quant.py::test_quantize_rows_negative_only_rows',
    ),
    'tests/test_distributed.py::test_quantize_rows_sentinel_rows_keep_zero_scale': (
        'tests/test_torch_quant.py::test_quantize_rows_sentinel_rows_keep_zero_scale',
    ),
    'tests/test_distributed.py::test_sharded_flash_decode_matches_oracle': (
        'tests/test_torch_distributed.py::test_sharded_flash_decode_matches_oracle_and_reference',
    ),
    # tests/test_ess.py
    'tests/test_ess.py::test_dba_equals_da_results': (
        'tests/test_torch_overlap.py::test_dba_equals_da_results',
    ),
    'tests/test_ess.py::test_engine_prefill_chunked_matches_train': (
        'tests/test_torch_monolithic.py::test_engine_prefill_decode_matches_monolithic',
    ),
    'tests/test_ess.py::test_engine_prefill_decode_matches_monolithic': (
        'tests/test_torch_monolithic.py::test_engine_prefill_decode_matches_monolithic',
    ),
    'tests/test_ess.py::test_intra_layer_similarity_eq1': (
        'tests/test_torch_quest.py::test_intra_layer_similarity_eq1',
    ),
    'tests/test_ess.py::test_lru_warmup_preheats_pool': (
        'tests/test_torch_slots.py::test_lru_warmup_pool_matches_reference',
    ),
    'tests/test_ess.py::test_overlap_modes_exact_vs_monolithic': (
        'tests/test_torch_overlap.py::test_overlap_modes_match_reference',
    ),
    'tests/test_ess.py::test_pool_reuse_reduces_misses': (
        'tests/test_torch_ess.py::test_ess_sparse_attention_matches_reference',
        'tests/test_torch_overlap.py::test_overlap_modes_match_reference',
    ),
    # tests/test_kernels.py
    'tests/test_kernels.py::test_fused_gather_attend_matches_dense': (
        'tests/test_torch_monolithic.py::test_fused_gather_attend_matches_dense',
    ),
    'tests/test_kernels.py::test_gather_pages': (
        'tests/test_torch_quant.py::test_gather_pages_plain_matches_pallas_bitwise',
    ),
    'tests/test_kernels.py::test_gather_pages_dequant': (
        'tests/test_torch_quant.py::test_gather_pages_dequant_plain_matches_pallas_bitwise',
    ),
    'tests/test_kernels.py::test_gather_rows': (
        'tests/test_torch_kernels.py::test_gather_rows_matches_pallas_bitwise',
        'tests/test_torch_kernels.py::test_gather_rows_batched_matches_pallas',
    ),
    'tests/test_kernels.py::test_gather_rows_dequant': (
        'tests/test_torch_quant.py::test_gather_rows_dequant_plain_matches_pallas_bitwise',
    ),
    'tests/test_kernels.py::test_indexer_scores': (
        'tests/test_torch_kernels.py::test_indexer_scores_matches_pallas',
    ),
    'tests/test_kernels.py::test_indexer_topk_selects_valid_only': (
        'tests/test_torch_monolithic.py::test_indexer_topk_selects_valid_only',
    ),
    'tests/test_kernels.py::test_sparse_mla_batched_and_finalize': (
        'tests/test_torch_kernels.py::test_sparse_mla_partial_matches_pallas',
        'tests/test_torch_kernels.py::test_sparse_mla_empty_partial_merges_without_nan',
    ),
    'tests/test_kernels.py::test_sparse_mla_partial': (
        'tests/test_torch_kernels.py::test_sparse_mla_partial_matches_pallas',
    ),
    # tests/test_lru_pool.py
    'tests/test_lru_pool.py::test_invalidate_beyond_removes_stale_entries': (
        'tests/test_torch_slots.py::test_invalidate_beyond_matches_reference',
    ),
    'tests/test_lru_pool.py::test_lookup_marks_hits_and_packs_misses': (
        'tests/test_torch_ess.py::test_lookup_admit_tick_sequence_matches_reference',
    ),
    'tests/test_lru_pool.py::test_lru_guarantee_batched': (
        'tests/test_torch_ess.py::test_lookup_admit_tick_sequence_matches_reference',
        'tests/test_torch_ess.py::test_pool_tie_order_equal_stamps_and_empty_slots',
    ),
    'tests/test_lru_pool.py::test_lru_miss_counts_match_oracle_single_id': (
        'tests/test_torch_ess.py::test_lookup_admit_tick_sequence_matches_reference',
    ),
    'tests/test_lru_pool.py::test_miss_envelope_overflow_drops_lowest_priority': (
        'tests/test_torch_ess.py::test_lookup_admit_tick_sequence_matches_reference',
    ),
    'tests/test_lru_pool.py::test_pool_invariants': (
        'tests/test_torch_ess.py::test_lookup_admit_tick_sequence_matches_reference',
    ),
    'tests/test_lru_pool.py::test_protected_slots_not_evicted': (
        'tests/test_torch_ess.py::test_protected_slots_and_pool_size',
    ),
    # tests/test_models.py
    'tests/test_models.py::test_deepseek_router_bias_selection_only': (
        'tests/test_torch_archs.py::test_deepseek_router_bias_selection_only',
    ),
    'tests/test_models.py::test_full_config_param_counts': (
        'tests/test_torch_archs.py::test_full_config_param_counts',
        'tests/test_torch_stacks.py::test_full_config_param_counts',
    ),
    'tests/test_models.py::test_mamba2_chunked_matches_sequential': (
        'tests/test_torch_stacks.py::test_mamba2_chunked_matches_sequential',
    ),
    'tests/test_models.py::test_moe_routing_invariants': (
        'tests/test_torch_archs.py::test_moe_routing_invariants',
    ),
    'tests/test_models.py::test_prefill_decode_consistent_with_train': (
        'tests/test_torch_archs.py::test_prefill_decode_consistent_with_train',
        'tests/test_torch_stacks.py::test_prefill_decode_consistent_with_train',
    ),
    'tests/test_models.py::test_sliding_window_masks_differ': (
        'tests/test_torch_archs.py::test_sliding_window_masks_differ',
    ),
    'tests/test_models.py::test_train_forward_shapes_no_nan': (
        'tests/test_torch_archs.py::test_train_forward_matches_reference',
        'tests/test_torch_stacks.py::test_train_forward_matches_reference',
    ),
    # tests/test_mtp_serve.py
    'tests/test_mtp_serve.py::test_duplicate_miss_requests_admit_once': (
        'tests/test_torch_ess.py::test_lookup_admit_tick_sequence_matches_reference',
        'tests/test_torch_ess.py::test_ess_sparse_attention_q2_draft_verify_matches_reference',
    ),
    'tests/test_mtp_serve.py::test_invalidate_beyond_after_admit_consistent': (
        'tests/test_torch_slots.py::test_invalidate_beyond_matches_reference',
        'tests/test_torch_mtp.py::test_speculative_step_matches_reference',
    ),
    'tests/test_mtp_serve.py::test_q3_decode_matches_three_q1_steps': (
        'tests/test_torch_mtp.py::test_q3_decode_matches_three_q1_steps',
    ),
    'tests/test_mtp_serve.py::test_serve_mtp_full_acceptance_and_budget_clamp': (
        'tests/test_torch_mtp_session.py::test_spec_full_acceptance_and_budget_clamp',
    ),
    'tests/test_mtp_serve.py::test_serve_mtp_stream_parity_greedy': (
        'tests/test_torch_mtp_session.py::test_spec_session_streams_match_reference',
    ),
    'tests/test_mtp_serve.py::test_serve_mtp_tbo_stream_parity': (
        'tests/test_torch_tbo.py::test_tbo_session_streams_match_reference',
    ),
    'tests/test_mtp_serve.py::test_serve_sampling_deterministic_and_mode_invariant': (
        'tests/test_torch_mtp_session.py::test_sampled_stream_depends_on_seed_only',
        'tests/test_torch_mtp_session.py::test_spec_session_streams_match_reference',
    ),
    'tests/test_mtp_serve.py::test_spec_round_mid_finish_leaves_freed_slot_untouched': (
        'tests/test_torch_mtp_session.py::test_spec_round_mid_finish_leaves_freed_slot_untouched',
    ),
    # tests/test_overlap_pipeline.py
    'tests/test_overlap_pipeline.py::test_abort_and_admission_reuse_slab_slot': (
        'tests/test_torch_pipeline.py::test_abort_and_admission_reuse_slab_slot',
    ),
    'tests/test_overlap_pipeline.py::test_empty_slab_is_disarmed': (
        'tests/test_torch_transfer.py::test_empty_slab_matches_reference',
    ),
    'tests/test_overlap_pipeline.py::test_empty_slab_quantized_carries_scale_plane': (
        'tests/test_torch_transfer.py::test_empty_slab_matches_reference',
    ),
    'tests/test_overlap_pipeline.py::test_ess105_checker_flags_blocking_and_dead_prefetch':
        "none: ESS105 reads a backward slice of the round's jaxpr; in eager torch its rules are the card's slab-gather overlap (chip_smoke.py, session F) and prefetch hits > 0 (test_torch_pipeline.py)",
    'tests/test_overlap_pipeline.py::test_ess105_slicer_separates_exclusive_gathers':
        "none: ESS105 reads a backward slice of the round's jaxpr; the port has no lowered program",
    'tests/test_overlap_pipeline.py::test_fill_round_window_resets_per_promotion': (
        'tests/test_torch_pipeline.py::test_fill_rounds_counted_alike_in_both_modes',
    ),
    'tests/test_overlap_pipeline.py::test_fill_rounds_excluded_from_cadence_identically': (
        'tests/test_torch_pipeline.py::test_fill_rounds_counted_alike_in_both_modes',
    ),
    'tests/test_overlap_pipeline.py::test_match_staged_serves_only_staged_needed_rows': (
        'tests/test_torch_transfer.py::test_match_staged_matches_reference',
    ),
    'tests/test_overlap_pipeline.py::test_overlap_stream_parity': (
        'tests/test_torch_pipeline.py::test_pipelined_session_matches_reference_and_sync',
    ),
    'tests/test_overlap_pipeline.py::test_overlap_stream_parity_dense_host_tier': (
        'tests/test_torch_pipeline.py::test_pipelined_session_matches_reference_and_sync',
    ),
    'tests/test_overlap_pipeline.py::test_plan_prefetch_pads_when_candidates_run_out': (
        'tests/test_torch_transfer.py::test_plan_prefetch_matches_reference',
    ),
    'tests/test_overlap_pipeline.py::test_plan_prefetch_ranks_nonresident_in_horizon_by_score': (
        'tests/test_torch_transfer.py::test_plan_prefetch_matches_reference',
    ),
    'tests/test_overlap_pipeline.py::test_preemption_cancels_staged_and_replays_identically': (
        'tests/test_torch_pipeline.py::test_preemption_cancels_staged_and_replays_identically',
    ),
    'tests/test_overlap_pipeline.py::test_staged_slab_leaves_ride_donation':
        'none: ESS101 (donation): the slab is persistent state updated in place',
    'tests/test_overlap_pipeline.py::test_stop_truncation_rolls_back_staged_state': (
        'tests/test_torch_pipeline.py::test_stop_truncation_rolls_back_staged_state',
    ),
    'tests/test_overlap_pipeline.py::test_transfer_engine_lifecycle_edges_cancel_staged_ids': (
        'tests/test_torch_transfer.py::test_transfer_engine_edges_match_reference',
    ),
    # tests/test_paged_cache.py
    'tests/test_paged_cache.py::test_engine_paged_matches_dense_path': (
        'tests/test_torch_api.py::test_generate_dense_tier_matches_reference',
        'tests/test_torch_serving.py::test_prefill_and_teacher_forced_decode_match_reference',
    ),
    'tests/test_paged_cache.py::test_paged_is_default_for_offload_configs': (
        'tests/test_torch_ess.py::test_init_ess_caches_layout_matches_reference',
    ),
    'tests/test_paged_cache.py::test_paged_scatter_drops_unmapped_and_out_of_range': (
        'tests/test_torch_ess.py::test_paged_phys_matches_reference',
        'tests/test_torch_kernels.py::test_scatter_rows_plain_drops_out_of_range',
    ),
    'tests/test_paged_cache.py::test_paged_vs_dense_roundtrip_bitwise': (
        'tests/test_torch_ess.py::test_host_scatter_gather_match_reference',
    ),
    'tests/test_paged_cache.py::test_preempt_readmit_no_stale_pool_entries': (
        'tests/test_torch_session.py::test_preempt_readmit_no_stale_pool_entries',
    ),
    'tests/test_paged_cache.py::test_reset_slot_clears_pool_maps': (
        'tests/test_torch_slots.py::test_slot_lifecycle_matches_reference',
    ),
    'tests/test_paged_cache.py::test_serve_loop_streams_requests_page_gated': (
        'tests/test_torch_session.py::test_serve_loop_streams_requests_page_gated',
    ),
    'tests/test_paged_cache.py::test_slot_latents_gather_pages_kernel_parity': (
        'tests/test_torch_quant.py::test_init_slot_latents_and_graft_match_reference',
    ),
    # tests/test_paper_numbers.py
    'tests/test_paper_numbers.py::test_fig1_batch_ceiling_and_monotonic_growth': (
        'tests/test_torch_simulator.py::test_paper_fig1_batch_ceiling_and_monotonic_growth',
    ),
    'tests/test_paper_numbers.py::test_fig2_similarity_band': (
        'tests/test_torch_simulator.py::test_paper_fig2_similarity_band',
    ),
    'tests/test_paper_numbers.py::test_fig4_warmup_kills_cold_spike': (
        'tests/test_torch_simulator.py::test_paper_fig4_warmup_kills_cold_spike',
    ),
    'tests/test_paper_numbers.py::test_fig5_layer_variability_range': (
        'tests/test_torch_simulator.py::test_paper_fig5_layer_variability_range',
    ),
    'tests/test_paper_numbers.py::test_fig7_da_dba_crossover': (
        'tests/test_torch_simulator.py::test_paper_fig7_da_dba_crossover',
    ),
    'tests/test_paper_numbers.py::test_fig9_miss_decreases_with_context': (
        'tests/test_torch_simulator.py::test_paper_fig9_miss_decreases_with_context',
    ),
    'tests/test_paper_numbers.py::test_flashtrans_bandwidth_effect': (
        'tests/test_torch_simulator.py::test_paper_flashtrans_bandwidth_effect',
    ),
    'tests/test_paper_numbers.py::test_headline_improvements_within_band': (
        'tests/test_torch_simulator.py::test_paper_headline_improvements_within_band',
    ),
    'tests/test_paper_numbers.py::test_locality_trace_similarity_matches_churn': (
        'tests/test_torch_simulator.py::test_paper_locality_trace_similarity_matches_churn',
    ),
    'tests/test_paper_numbers.py::test_lru_sim_warmup_monotone_in_ratio': (
        'tests/test_torch_simulator.py::test_paper_lru_sim_warmup_monotone_in_ratio',
    ),
    'tests/test_paper_numbers.py::test_memory_ceilings_match_paper_operating_points': (
        'tests/test_torch_simulator.py::test_paper_memory_ceilings_match_operating_points',
    ),
    'tests/test_paper_numbers.py::test_table2_rows_within_tolerance': (
        'tests/test_torch_simulator.py::test_paper_table2_rows_within_tolerance',
    ),
    'tests/test_paper_numbers.py::test_v5e_projection_ess_wins_more_on_smaller_hbm': (
        'tests/test_torch_simulator.py::test_paper_v5e_projection_ess_wins_more_on_smaller_hbm',
    ),
    # tests/test_quant_cache.py
    'tests/test_quant_cache.py::test_admission_blocks_on_bytes_not_pages': (
        'tests/test_torch_session.py::test_host_byte_budget_gates_admission',
    ),
    'tests/test_quant_cache.py::test_byte_budget_floors_pages_by_storage_dtype': (
        'tests/test_torch_quant_tier.py::test_byte_budget_floors_pages_by_storage_dtype',
    ),
    'tests/test_quant_cache.py::test_engine_state_gains_only_scale_leaves': (
        'tests/test_torch_quant_tier.py::test_engine_state_gains_only_scale_leaves',
    ),
    'tests/test_quant_cache.py::test_ess106_checker_flags_tier_sized_dequant': (
        'tests/test_torch_analysis.py::test_tier_dequant_finder_on_profiled_ops',
        'tests/test_torch_analysis.py::test_tier_dequant_audit_catches_whole_tier_dequant',
    ),
    'tests/test_quant_cache.py::test_ess106_clean_on_quantized_programs': (
        'tests/test_torch_analysis.py::test_tier_dequant_golden_int8_round',
        'tests/test_torch_analysis.py::test_tier_dequant_golden_fp8_round',
    ),
    'tests/test_quant_cache.py::test_ess106_flags_bf16_tier_as_unquantized': (
        'tests/test_torch_quant_tier.py::test_ess106_flags_bf16_tier_as_unquantized',
    ),
    'tests/test_quant_cache.py::test_find_big_dequants_on_synthetic_jaxpr': (
        'tests/test_torch_analysis.py::test_tier_dequant_finder_on_profiled_ops',
    ),
    # the bf16-equality claim fails in both packages (random weights, a
    # near-tie at the same rid and token); the port test holds each tier's
    # streams equal to the reference's and where the two tiers part
    'tests/test_quant_cache.py::test_greedy_streams_match_bf16': (
        'tests/test_torch_quant_tier.py::test_tier_streams_and_rounds_match_reference',
    ),
    'tests/test_quant_cache.py::test_host_tier_rows_drift_is_scale_bounded': (
        'tests/test_torch_quant_tier.py::test_host_tier_rows_drift_is_scale_bounded',
    ),
    # as above: the bf16-equality claim fails in both packages; accept rate,
    # speculative rounds and streams held equal to the reference's per tier
    'tests/test_quant_cache.py::test_mtp_acceptance_within_2pct_of_bf16': (
        'tests/test_torch_quant_tier.py::test_mtp_spec_rounds_and_accept_rate_match_reference',
    ),
    'tests/test_quant_cache.py::test_quantized_programs_donate_all_leaves':
        "none: ESS101 (donation): the port's rounds update one state in place",
    'tests/test_quant_cache.py::test_roundtrip_bf16_rows_land_on_grid': (
        'tests/test_torch_quant.py::test_quantize_rows_bitwise_with_edge_cases',
    ),
    'tests/test_quant_cache.py::test_roundtrip_error_is_scale_bounded': (
        'tests/test_torch_quant.py::test_quantize_rows_bitwise_with_edge_cases',
    ),
    # tests/test_quest.py
    'tests/test_quest.py::test_incremental_meta_update_matches_rebuild': (
        'tests/test_torch_quest.py::test_incremental_meta_update_matches_rebuild',
    ),
    'tests/test_quest.py::test_quest_attention_exact_over_selection': (
        'tests/test_torch_quest.py::test_quest_attention_matches_reference',
    ),
    'tests/test_quest.py::test_quest_blocks_pool_roundtrip': (
        'tests/test_torch_quest.py::test_quest_blocks_pool_roundtrip',
    ),
    'tests/test_quest.py::test_quest_selection_captures_softmax_mass': (
        'tests/test_torch_quest.py::test_quest_selection_captures_softmax_mass',
    ),
    'tests/test_quest.py::test_quest_upper_bound_is_sound': (
        'tests/test_torch_quest.py::test_block_meta_and_scores_exact',
    ),
    # tests/test_serving.py
    'tests/test_serving.py::test_feasible_batch_size_formula': (
        'tests/test_torch_slots.py::test_feasible_batch_size_formula',
    ),
    'tests/test_serving.py::test_mtp_spec_rollback_gated_on_slot_mask': (
        'tests/test_torch_mtp.py::test_speculative_step_matches_reference',
    ),
    'tests/test_serving.py::test_mtp_speculative_rollback_semantics': (
        'tests/test_torch_mtp.py::test_speculative_step_matches_reference',
    ),
    'tests/test_serving.py::test_paged_kv_append_and_gather': (
        'tests/test_torch_quest.py::test_paged_kv_append_and_gather',
    ),
    'tests/test_serving.py::test_sampling_greedy_and_temperature': (
        'tests/test_torch_sampling.py::test_greedy_and_temperature_zero',
    ),
    'tests/test_serving.py::test_scheduler_admission_completion_preemption': (
        'tests/test_torch_slots.py::test_scheduler_admission_completion_preemption',
    ),
    'tests/test_serving.py::test_scheduler_rejects_oversize': (
        'tests/test_torch_slots.py::test_scheduler_rejects_oversize',
    ),
    'tests/test_serving.py::test_two_batch_overlap_split_merge': (
        'tests/test_torch_tbo.py::test_two_batch_step_split_merge',
    ),
    # tests/test_system.py
    'tests/test_system.py::test_ess_decode_with_kernels_matches_jnp_path': (
        'tests/test_torch_serving.py::test_decode_step_matches_reference_use_kernel',
    ),
    'tests/test_system.py::test_ess_greedy_continuation_matches_monolithic': (
        'tests/test_torch_monolithic.py::test_ess_greedy_continuation_matches_monolithic',
    ),
    'tests/test_system.py::test_layerwise_policy_picks_dba_for_heavy_layers': (
        'tests/test_torch_overlap.py::test_layerwise_policy_picks_dba_for_heavy_layers',
    ),
    # tests/test_training.py
    'tests/test_training.py::test_adamw_decreases_loss': (
        'tests/test_torch_training.py::test_adamw_decreases_loss',
    ),
    'tests/test_training.py::test_checkpoint_gc_keeps_latest': (
        'tests/test_torch_training.py::test_checkpoint_roundtrip_integrity_and_gc',
    ),
    'tests/test_training.py::test_checkpoint_roundtrip_and_integrity': (
        'tests/test_torch_training.py::test_checkpoint_roundtrip_integrity_and_gc',
    ),
    'tests/test_training.py::test_data_pipeline_determinism_and_host_sharding': (
        'tests/test_torch_training.py::test_make_batch_matches_reference',
    ),
    'tests/test_training.py::test_elastic_restore_resharding': (
        'tests/test_torch_training.py::test_restore_places_leaves_by_device_fn',
    ),
    'tests/test_training.py::test_grad_accumulation_matches_full_batch': (
        'tests/test_torch_training.py::test_grad_accumulation_matches_full_batch',
    ),
    'tests/test_training.py::test_int8_compression_error_feedback': (
        'tests/test_torch_training.py::test_int8_compression_error_feedback_matches_reference',
    ),
    'tests/test_training.py::test_lr_schedule': (
        'tests/test_torch_training.py::test_lr_schedule_matches_reference',
    ),
    'tests/test_training.py::test_train_loop_resumes_from_checkpoint': (
        'tests/test_torch_training.py::test_train_loop_resumes_from_checkpoint',
    ),}
