// Megastep: `chunk` fetch/decode/execute steps of every fleet lane in one
// launch — the Hopper counterpart of the TPU kernel
// src/repro/kernels/megastep/kernel.py::megastep_chunk (Pallas).
//
// What it computes: exactly `chunk` iterations of the fleet step
// (repro_torch.core.fleet._step_core) on untraced lanes whose guest-kernel
// emulation is off (k_enabled == 0; the wrapper refuses other lanes).  The
// result is bit-identical to the plain PyTorch version in ../ref.py.
//
// Design: one thread per lane.  At entry a thread loads its lane's
// registers and scalar leaves into registers / local memory, runs the
// chunk as a plain C loop, and writes every leaf back once at the end (the
// merged writeback of the TPU kernel).  The 13 op-spec columns and the
// syscall rows go to shared memory at block start; decode tables are read
// through ids[lane].  The lane's 256 KiB memory stays in device memory:
// it cannot fit on chip (one SM has 227 KB of shared memory).  The rare
// paths — read fill / write sum over the lane's own io_k <= 4096 words and
// the 34-word sigframe push — are plain loops in the thread.
//
// What bounds it on this card: a serial chain of dependent steps (the
// census's longest lane runs ~8.3k steps), each a few dependent device
// memory accesses (instruction fetch, then the data word).  The bytes and
// operations are tiny next to the card's rates; the chain's latency is the
// limit.  The design does nothing about that yet: 500 lanes fill ~16
// warps.  Spreading lanes over more SMs and warps is later work.
//
// Integer semantics: JAX int64 arithmetic wraps; C++ signed overflow is
// undefined, so every add / sub / mul / left shift that can overflow goes
// through uint64_t (wadd, wsub, wmul, wshl).  Right shifts of signed values
// are arithmetic, as in JAX (nvcc emits shr.s64).
#include <cstdint>
#include <cuda_runtime.h>

#include "megastep_consts.h"

struct MegastepArgs {
    const int64_t* packed;     // [G, CODE_WORDS] op:6 rd:5 rn:5 rm:5 sh:6 cond:4 sf:1
    const int64_t* imm;        // [G, CODE_WORDS]
    const int32_t* ids;        // [B] image row per lane
    // the 13 op-spec columns ([N_OPS], COND_MASK [16]); bool columns are
    // one byte per entry
    const int32_t* alu;
    const uint8_t* wb_sp;
    const uint8_t* wb_lr;
    const int32_t* flags;
    const int32_t* memc;
    const uint8_t* addr_post;
    const uint8_t* wb_base;
    const int32_t* pcc;
    const uint8_t* segv;
    const uint8_t* exit_;
    const int64_t* signo;
    const int64_t* cost;
    const int64_t* cond_mask;
    // the syscall rows ([N_SYSCALLS])
    const int64_t* sys_nr;
    const int64_t* sys_kind;
    const int64_t* sys_const;
    // the MachineState leaves, in field order, each [B, ...] int64
    int64_t* leaf[N_LEAVES];
    int64_t n_lanes;
    int64_t chunk;
};

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a * (uint64_t)b);
}
__device__ __forceinline__ int64_t wshl(int64_t a, int64_t s) {  // 0 <= s < 64
    return (int64_t)((uint64_t)a << s);
}
__device__ __forceinline__ int64_t clampi(int64_t x, int64_t lo, int64_t hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ bool mem_ok(int64_t addr) {
    return addr >= DATA_BASE && addr < MEM_LIMIT && (addr & 7) == 0;
}
// Word index of an address, clipped into the lane (fleet.py:189): the
// subtraction wraps and the shift is arithmetic, so an address below
// DATA_BASE clips to word 0.
__device__ __forceinline__ int64_t widx(int64_t addr) {
    return clampi(wsub(addr, DATA_BASE) >> 3, 0, MEM_WORDS - 1);
}
// JAX's // floors; CUDA's / truncates toward zero (io_n may be negative).
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
    return q;
}

__global__ void megastep_kernel(const MegastepArgs a) {
    __shared__ int32_t s_alu[N_OPS], s_flags[N_OPS], s_memc[N_OPS], s_pcc[N_OPS];
    __shared__ uint8_t s_wb_sp[N_OPS], s_wb_lr[N_OPS], s_addr_post[N_OPS],
        s_wb_base[N_OPS], s_segv[N_OPS], s_exit[N_OPS];
    __shared__ int64_t s_signo[N_OPS], s_cost[N_OPS], s_cond[16];
    __shared__ int64_t s_sys_nr[N_SYSCALLS], s_sys_kind[N_SYSCALLS],
        s_sys_const[N_SYSCALLS];
    for (int i = threadIdx.x; i < N_OPS; i += blockDim.x) {
        s_alu[i] = a.alu[i];
        s_flags[i] = a.flags[i];
        s_memc[i] = a.memc[i];
        s_pcc[i] = a.pcc[i];
        s_wb_sp[i] = a.wb_sp[i];
        s_wb_lr[i] = a.wb_lr[i];
        s_addr_post[i] = a.addr_post[i];
        s_wb_base[i] = a.wb_base[i];
        s_segv[i] = a.segv[i];
        s_exit[i] = a.exit_[i];
        s_signo[i] = a.signo[i];
        s_cost[i] = a.cost[i];
    }
    for (int i = threadIdx.x; i < 16; i += blockDim.x) s_cond[i] = a.cond_mask[i];
    for (int i = threadIdx.x; i < N_SYSCALLS; i += blockDim.x) {
        s_sys_nr[i] = a.sys_nr[i];
        s_sys_kind[i] = a.sys_kind[i];
        s_sys_const[i] = a.sys_const[i];
    }
    __syncthreads();

    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= a.n_lanes) return;  // the ragged edge of the last block

    // -- load the lane's carry ---------------------------------------------
    int64_t r[31];
    int64_t* regs_p = a.leaf[LEAF_regs] + lane * 31;
    for (int i = 0; i < 31; ++i) r[i] = regs_p[i];
    int64_t sp = a.leaf[LEAF_sp][lane];
    int64_t pc = a.leaf[LEAF_pc][lane];
    int64_t nzcv = a.leaf[LEAF_nzcv][lane];
    int64_t cycles = a.leaf[LEAF_cycles][lane];
    int64_t icount = a.leaf[LEAF_icount][lane];
    const int64_t fuel = a.leaf[LEAF_fuel][lane];
    int64_t halted = a.leaf[LEAF_halted][lane];
    int64_t exit_code = a.leaf[LEAF_exit_code][lane];
    int64_t fault_pc = a.leaf[LEAF_fault_pc][lane];
    const int64_t sig_handler = a.leaf[LEAF_sig_handler][lane];
    int64_t in_signal = a.leaf[LEAF_in_signal][lane];
    const bool in_pt = a.leaf[LEAF_ptrace][lane] != 0;
    const bool virt = in_pt && a.leaf[LEAF_virt_getpid][lane] != 0;
    int64_t hook_count = a.leaf[LEAF_hook_count][lane];
    const int64_t pid = a.leaf[LEAF_pid][lane];
    int64_t in_off = a.leaf[LEAF_in_off][lane];
    int64_t out_count = a.leaf[LEAF_out_count][lane];
    int64_t out_sum = a.leaf[LEAF_out_sum][lane];
    int64_t enosys_count = a.leaf[LEAF_enosys_count][lane];
    int64_t* mem = a.leaf[LEAF_mem] + lane * MEM_WORDS;
    const int64_t img_row = a.ids[lane];
    const int64_t* code = a.packed + img_row * CODE_WORDS;
    const int64_t* imms = a.imm + img_row * CODE_WORDS;

    for (int64_t t = 0; t < a.chunk; ++t) {
        // A lane that is not live stays not live for the rest of the chunk
        // (halted never returns to RUNNING, icount only grows while live),
        // and masked steps are the identity: stop early.
        if (!(halted == RUNNING && icount < fuel)) break;
        const int64_t pc0 = pc, sp0 = sp, nzcv0 = nzcv;

        // -- fetch + decode ------------------------------------------------
        const bool ok_fetch = pc0 >= 0 && pc0 < CODE_LIMIT && (pc0 & 3) == 0;
        const int64_t fi = clampi(pc0 >> 2, 0, CODE_WORDS - 1);
        const int64_t w = code[fi];
        const int64_t imm = imms[fi];
        int op = ok_fetch ? (int)(w & 63) : OP_NULLPAGE;
        if (op > N_OPS - 1) op = N_OPS - 1;  // JAX gathers clamp the index
        const int rd = (int)((w >> 6) & 31);
        const int rn = (int)((w >> 11) & 31);
        const int rm = (int)((w >> 16) & 31);
        const int sh = (int)((w >> 22) & 63);
        const int cond = (int)((w >> 28) & 15);
        const int sf = (int)((w >> 32) & 1);

        const int aluc = s_alu[op], flagc = s_flags[op];
        const int memc = s_memc[op], pcc = s_pcc[op];
        const bool m_svc = pcc == P_SVC;
        const bool m_null = s_segv[op] != 0;
        const bool m_hlt = s_exit[op] != 0;
        const bool dlv = pcc == P_TRAP;
        const bool ld_single = memc == M_LOAD, st_single = memc == M_STORE;
        const bool ld_pair = memc == M_LOAD_P, st_pair = memc == M_STORE_P;
        const bool st_byte = memc == M_STORE_BYTE;
        const bool byte_op = memc == M_LOAD_BYTE || st_byte;

        // -- register reads (reg 31 is XZR for _rr, SP for _rsp) -----------
        const int ra = (int)clampi(imm, 0, 31);  // madd packs ra into imm
        const int64_t rn_raw = r[rn < 30 ? rn : 30];
        const int64_t rn_rr = rn == 31 ? 0 : rn_raw;
        const int64_t rn_rsp = rn == 31 ? sp0 : rn_raw;
        const int64_t rm_rr = rm == 31 ? 0 : r[rm < 30 ? rm : 30];
        const int64_t rd_rr = rd == 31 ? 0 : r[rd < 30 ? rd : 30];
        const int64_t ra_rr = ra == 31 ? 0 : r[ra < 30 ? ra : 30];
        const int64_t x0 = r[0], io_buf = r[1], io_n = r[2], nr = r[8];

        // -- memory addressing ---------------------------------------------
        const int64_t addr_a = s_addr_post[op] ? rn_rsp : wadd(rn_rsp, imm);
        const int64_t eff1 = byte_op ? (addr_a & ~(int64_t)7) : addr_a;
        const bool ok1 = byte_op ? (addr_a >= DATA_BASE && addr_a < MEM_LIMIT)
                                 : mem_ok(eff1);
        const int64_t addr2 = wadd(addr_a, 8);
        const bool ok2 = mem_ok(addr2);
        const int64_t g1 = widx(eff1), g2 = widx(addr2);
        // Reads come from the pre-store memory.  The words are consumed only
        // by memory-class ops, so other ops skip the loads.
        int64_t v1 = 0, v2 = 0;
        if (memc != M_NONE || aluc == A_LOAD || aluc == A_LOAD_B) v1 = mem[g1];
        if (ld_pair) v2 = mem[g2];

        const int64_t byte_shift = (addr_a & 7) * 8;
        const int64_t byte_val = (v1 >> byte_shift) & 0xFF;
        const int64_t strb_word =
            (int64_t)(((uint64_t)v1 & ~((uint64_t)0xFF << byte_shift))
                      | (((uint64_t)rd_rr & 0xFF) << byte_shift));
        const int64_t ld1 = ok1 ? v1 : 0;
        const int64_t ld2 = ok2 ? v2 : 0;

        // -- ALU / mov / load value for the primary register write ----------
        // (the class switch is the JAX select chain: the classes are
        // disjoint, one per op)
        const int64_t piece = wshl(imm, sh);
        int64_t slot_val = 0;
        switch (aluc) {
            case A_MOVZ:
            case A_MOVN:
            case A_MOVK: {
                int64_t mv;
                if (aluc == A_MOVZ) mv = piece;
                else if (aluc == A_MOVN) mv = ~piece;
                else mv = (int64_t)(((uint64_t)rd_rr & ~((uint64_t)0xFFFF << sh))
                                    | (uint64_t)piece);
                if (sf != 1) mv &= (int64_t)0xFFFFFFFF;
                slot_val = mv;
                break;
            }
            case A_ADRP: slot_val = wadd(pc0 & ~(int64_t)0xFFF, imm); break;
            case A_ADR: slot_val = wadd(pc0, imm); break;
            case A_ADD_I: slot_val = wadd(rn_rsp, imm); break;
            case A_SUB_I: slot_val = wsub(rn_rsp, imm); break;
            case A_ADD_R: slot_val = wadd(rn_rr, rm_rr); break;
            case A_SUB_R: slot_val = wsub(rn_rr, rm_rr); break;
            case A_ORR: slot_val = rn_rr | rm_rr; break;
            case A_AND: slot_val = rn_rr & rm_rr; break;
            case A_EOR: slot_val = rn_rr ^ rm_rr; break;
            case A_MADD: slot_val = wadd(wmul(rn_rr, rm_rr), ra_rr); break;
            case A_LSL: slot_val = wshl(rn_rr, sh); break;
            case A_LOAD: slot_val = ld1; break;
            case A_LOAD_B: slot_val = byte_val; break;
            case A_LINK: slot_val = wadd(pc0, 4); break;
            default: break;
        }

        // -- flags (NZCV from a subtract) -----------------------------------
        if (flagc != F_NONE) {
            const bool f_imm = flagc == F_SUBS_I;
            const int64_t fa = f_imm ? rn_rsp : rn_rr;
            const int64_t fb = f_imm ? imm : rm_rr;
            const int64_t res = wsub(fa, fb);
            nzcv = (res < 0 ? 8 : 0) + (res == 0 ? 4 : 0)
                 + ((uint64_t)fa >= (uint64_t)fb ? 2 : 0)  // carry: unsigned
                 + (((fa ^ fb) & (fa ^ res)) < 0 ? 1 : 0);
        }

        // -- syscalls: the emulation-off rows --------------------------------
        // openat / close return their historical constants; the other
        // emulated kinds fall through to -ENOSYS.
        bool sys_read = false, sys_write = false, sys_getpid = false;
        bool sys_exit = false, sys_sigret = false, sys_const = false;
        bool known = false;
        int64_t const_val = 0;
        if (m_svc) {
            for (int i = 0; i < N_SYSCALLS; ++i) {
                if (nr != s_sys_nr[i]) continue;
                const int64_t kind = s_sys_kind[i];
                bool k = true;
                if (kind == K_IO_READ) sys_read = true;
                else if (kind == K_IO_WRITE) sys_write = true;
                else if (kind == K_GETPID) sys_getpid = true;
                else if (kind == K_EXIT) sys_exit = true;
                else if (kind == K_SIGRETURN) sys_sigret = true;
                else if (kind == K_CONST || kind == K_OPENAT || kind == K_CLOSE) {
                    sys_const = true;
                    const_val = s_sys_const[i];
                } else k = false;
                known = known || k;
            }
        }
        const bool sys_enosys = m_svc && !known;
        const bool sys_io = sys_read || sys_write;

        const int64_t io_k = clampi(io_n >> 3, 0, MAX_IO_WORDS);
        const bool io_ok = mem_ok(io_buf) && wadd(io_buf, io_n) <= MEM_LIMIT
                           && io_n >= 0 && (io_n & 7) == 0;
        const int64_t io_start = widx(io_buf);

        int64_t svc_x0 = 0;
        if (sys_io) svc_x0 = io_ok ? io_n : -14;
        else if (sys_getpid) svc_x0 = virt ? VIRT_PID : pid;
        else if (sys_const) svc_x0 = const_val;
        else if (sys_enosys) svc_x0 = -38;
        const bool svc_x0_en = m_svc && !(sys_exit || sys_sigret);

        // -- signal delivery -------------------------------------------------
        const bool can_sig = dlv && sig_handler != 0 && in_signal == 0;
        const bool trap_fail = dlv && !can_sig;

        // -- memory writes, in the JAX order: stores, sigframe push, I/O ----
        // JAX parks disabled stores at out-of-range indices and drops them;
        // here a disabled store is simply not made.  A pair store whose
        // second word faults keeps its first.
        if ((st_single || st_pair || st_byte) && ok1)
            mem[g1] = byte_op ? strb_word : rd_rr;
        if (st_pair && ok2) mem[g2] = rm_rr;
        if (can_sig) {  // the frame saves the PRE-step registers and flags
            int64_t* f = mem + SIGFRAME_IDX;
            for (int i = 0; i < 31; ++i) f[i] = r[i];
            f[31] = sp0;
            f[32] = pc0;
            f[33] = nzcv0;
        }
        // I/O: words [io_start, io_start + io_k) of the lane — the net effect
        // of the JAX engine's clamped 512-word windows (io_ok keeps the span
        // inside the lane).  The write sum reads memory after the stores.
        int64_t io_sum = 0;
        if (sys_io && io_ok) {
            int64_t* p = mem + io_start;
            if (sys_read) {
                for (int64_t j = 0; j < io_k; ++j) p[j] = wadd(in_off, j * 8);
            } else {
                for (int64_t j = 0; j < io_k; ++j) io_sum = wadd(io_sum, p[j]);
            }
        }

        // -- register writes (slot order of the JAX executor) ----------------
        if (aluc != A_NONE) {
            const int idx = s_wb_lr[op] ? 30 : rd;
            if (idx < 31) r[idx] = slot_val;
            else if (s_wb_sp[op]) sp = slot_val;  // _wsp ops: rd 31 is SP
        }
        if (ld_pair && rm < 31) r[rm] = ld2;
        if (s_wb_base[op]) {
            const int64_t v = wadd(rn_rsp, imm);
            if (rn < 31) r[rn] = v;
            else sp = v;
        }
        if (svc_x0_en) r[0] = svc_x0;
        if (can_sig) {
            r[0] = s_signo[op];
            r[1] = SIGFRAME;
            sp = SIGSTACK_TOP;
        }
        int64_t frame_pc = 0;
        if (sys_sigret) {  // the frame is read from the FINAL memory
            const int64_t* f = mem + SIGFRAME_IDX;
            for (int i = 0; i < 31; ++i) r[i] = f[i];
            sp = f[31];
            frame_pc = f[32];
            nzcv = f[33];
        }

        // -- program counter (b.cond tests the OLD flags) --------------------
        const int64_t br = wadd(pc0, imm), pc4 = wadd(pc0, 4);
        switch (pcc) {
            case P_REL: pc = br; break;
            case P_IND: pc = rn_rr; break;
            case P_CBZ: pc = rd_rr == 0 ? br : pc4; break;
            case P_CBNZ: pc = rd_rr != 0 ? br : pc4; break;
            case P_BCOND: pc = ((s_cond[cond] >> (nzcv0 & 15)) & 1) ? br : pc4; break;
            case P_STAY: pc = pc0; break;
            case P_TRAP: pc = can_sig ? sig_handler : pc0; break;
            case P_SVC:
                pc = sys_exit ? pc0 : (sys_sigret ? wadd(frame_pc, 4) : pc4);
                break;
            default: pc = pc4; break;
        }

        // -- faults / halts (later assignments win, as in the JAX chain) ----
        const bool mem_bad = ((ld_single || st_single) && !ok1)
                             || ((ld_pair || st_pair) && !(ok1 && ok2))
                             || (byte_op && !ok1);
        if (m_null) halted = HALT_SEGV;
        if (mem_bad) halted = HALT_BADMEM;
        if (m_hlt || sys_exit) {
            halted = HALT_EXIT;
            exit_code = x0;
        }
        if (trap_fail) halted = HALT_TRAP;
        if (m_null || mem_bad || trap_fail) fault_pc = pc0;

        // -- bookkeeping -----------------------------------------------------
        cycles = wadd(cycles, s_cost[op]);
        if (m_svc) {
            cycles = wadd(cycles, KERNEL_CROSS);
            if (in_pt) {
                cycles = wadd(cycles, 2 * PTRACE_STOP);
                hook_count = wadd(hook_count, 1);
            }
        }
        if (sys_io) cycles = wadd(cycles, floor_div(io_n, IO_BYTES_PER_CYCLE));
        if (can_sig) cycles = wadd(cycles, SIGNAL_DELIVERY);
        icount = wadd(icount, 1);
        if (sys_read && io_ok) in_off = wadd(in_off, io_n);
        if (sys_write && io_ok) {
            out_count = wadd(out_count, io_n);
            out_sum = wadd(out_sum, io_sum);
        }
        if (can_sig) in_signal = 1;
        else if (sys_sigret) in_signal = 0;
        if (sys_enosys) enosys_count = wadd(enosys_count, 1);
    }

    // -- merged writeback -----------------------------------------------------
    for (int i = 0; i < 31; ++i) regs_p[i] = r[i];
    a.leaf[LEAF_sp][lane] = sp;
    a.leaf[LEAF_pc][lane] = pc;
    a.leaf[LEAF_nzcv][lane] = nzcv;
    a.leaf[LEAF_cycles][lane] = cycles;
    a.leaf[LEAF_icount][lane] = icount;
    a.leaf[LEAF_halted][lane] = halted;
    a.leaf[LEAF_exit_code][lane] = exit_code;
    a.leaf[LEAF_fault_pc][lane] = fault_pc;
    a.leaf[LEAF_in_signal][lane] = in_signal;
    a.leaf[LEAF_hook_count][lane] = hook_count;
    a.leaf[LEAF_in_off][lane] = in_off;
    a.leaf[LEAF_out_count][lane] = out_count;
    a.leaf[LEAF_out_sum][lane] = out_sum;
    a.leaf[LEAF_enosys_count][lane] = enosys_count;
}

// Launch on `stream` (PyTorch's current stream); no synchronisation.
// Returns cudaGetLastError() so the wrapper can raise on a refused launch.
extern "C" int megastep_launch(const MegastepArgs* args, int block, void* stream) {
    const int64_t grid = (args->n_lanes + block - 1) / block;
    megastep_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
