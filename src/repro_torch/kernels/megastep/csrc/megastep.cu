// Megastep: `chunk` fetch/decode/execute steps of every fleet lane in one
// launch — the Hopper counterpart of the TPU kernel
// src/repro/kernels/megastep/kernel.py::megastep_chunk (Pallas), all three
// of its variants in one kernel:
//   K1  the untraced executor (ALU, flags, memory, branches, signals, the
//       syscall rows with the guest-kernel emulation off);
//   K3  the guest-kernel emulation service (fd tables, in-memory files,
//       pipes, /proc, getrandom, ioctl) and its data mover, on the lanes
//       whose k_enabled is set;
//   K2  with a trace carry (trace_cap > 0): the seccomp-style policy gate,
//       the record ring, the histogram and the verdict counters.
//
// What it computes: exactly `chunk` iterations of the fleet step
// (repro_torch.core.fleet._step_core).  The result is bit-identical to the
// plain PyTorch version in ../ref.py.
//
// Design: one warp per lane, `block` lanes (warps) a block.  All 32
// threads of a warp decode the same instruction and compute the same step
// scalars (pc, flags, addresses, the verdict, the svc family), so every
// branch is warp-uniform.  The guest registers live in the warp's
// registers: thread i holds x_i (i < 31; thread 31 holds nothing, SP is a
// step scalar), reads are __shfl_sync, a write is `x = lid == idx ? v : x`.
// The bulk work is spread over the warp, strided by 32 threads: the
// stream-I/O fill and sum, the data mover (file data, /proc, getrandom),
// the 34-word sigframe push and pop, the trace record; the searches are
// ballots: the syscall and policy rows (thread i holds row i), the free
// fd, open-file and inode slots and the open's inode lookup (thread i
// holds slot i).  Each word a step writes has one writer thread per phase;
// a step that writes memory ends with __syncwarp(), which orders those
// writes before the next step's reads by the other threads.  A decode
// table built once a carry (megastep_decode) gives each code word its
// op's 13 op-spec columns packed into one word, so a step's fetch is one
// read-only load (__ldg) with no lookup on its chain.  The step's body is
// compiled four times, one instance picked a step from the decode word:
// the full one for svc, trap, halt and null-page steps, a lean one for
// loads, stores and the rest, one without memory for ALU and move ops and
// one for branches; each leaves out the code its ops never reach, and the
// step's time follows the length of its path (fetching the fall-through
// instruction a step ahead, or the ALU class and the pc as select chains,
// ran slower).  The carry is loaded once and every leaf written back once
// at the end (the merged writeback of the TPU kernel).  The lane's 256 KiB
// memory stays in device memory: it cannot fit on chip (one SM has 227 KB
// of shared memory).
//
// Memory order inside a step is the JAX order: reads from the pre-store
// memory; the service's table updates, result words and data mover; the
// stores; the sigframe push; stream I/O, whose write sum reads memory
// after the stores; the sigreturn pop from the final memory.  (A step is
// either an svc or a memory op or a trap, so at most one writing phase
// occurs; a __syncwarp() stands before each phase whose readers or
// writers differ from the previous one's all the same.)
//
// Data mover arithmetic: as in the JAX package, source indices are clipped
// into the WHOLE flat plane (mem, k_ino_data) and destination indices past
// its end are dropped.  While file offsets stay in [0, FILE_BYTES + 64]
// and inode sizes in [0, FILE_BYTES], the validity checks keep every move
// inside the lane's own rows, which is what makes one unsynchronised warp
// per lane exact.  A guest can leave that domain: lseek(SEEK_SET) takes any
// offset >= 0, and from an offset near INT64_MAX a write's end wraps
// negative, passes the EFBIG check and moves words into the next lane's
// k_ino_data row.  The reference does the same in lockstep; here it races
// with that lane's warp, so such states are outside the kernel's exact
// domain (tests/test_torch_emul.py shows the escape in both packages).
// /proc words are rendered from the lane's own pre-step counters.
//
// What bounds it on this card: a serial chain of dependent steps (the
// census's longest lane runs ~8.3k steps), each a few dependent accesses
// (the instruction fetch, the register shuffles, the data word) and a
// few hundred uniform instructions a warp issues one by one.  The bytes
// and operations are tiny next to the card's rates; the chain's latency
// is the limit.  One warp a lane removes divergence between lanes
// (a warp of 32 lanes serialised every distinct path of its lanes) and the
// local-memory register file; 500 lanes at 4 a block are 125 blocks, one
// warp per scheduler of the 132 SMs.
//
// Integer semantics: JAX int64 arithmetic wraps; C++ signed overflow is
// undefined, so every add / sub / mul / left shift that can overflow goes
// through uint64_t (wadd, wsub, wmul, wshl).  Right shifts of signed values
// are arithmetic, as in JAX (nvcc emits shr.s64).  JAX's // and % floor;
// CUDA's / and % truncate (floor_div, floor_mod).
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
    const int64_t* sys_emul;
    // the MachineState leaves, in field order, each [B, ...] int64
    int64_t* leaf[N_LEAVES];
    // the TraceState leaves, in field order (pol_action is int32); unused
    // when trace_cap == 0
    int64_t* tleaf[N_TRACE_LEAVES];
    int64_t n_lanes;
    int64_t chunk;
    int64_t trace_cap;         // CAP of the trace ring; 0 = untraced
    // [G, CODE_WORDS] the decode words megastep_decode builds from packed:
    // its fields in bits 0-32, the op's op-spec word (op_word) from bit 33
    int64_t* uop;
};

// every thread of the warp takes part in each shuffle, ballot and reduction
static constexpr unsigned full_mask = 0xffffffffu;

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
// JAX's % takes the divisor's sign (b > 0 here); C's takes the dividend's.
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
    int64_t r = a % b;
    return r < 0 ? r + b : r;
}
__device__ __forceinline__ uint64_t splitmix64(uint64_t z) {
    z *= 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

// -- warp helpers -------------------------------------------------------------
__device__ __forceinline__ int64_t shfl(int64_t v, int src) {
    return (int64_t)__shfl_sync(full_mask, (long long)v, src);
}
// The wrapping 64-bit sum of the warp's values.  Addition modulo 2^64 is
// associative and commutative, so this tree gives the sequential loop's
// result bit for bit, whatever the order.
__device__ __forceinline__ int64_t warp_sum(int64_t v) {
    for (int o = 16; o > 0; o >>= 1)
        v = wadd(v, (int64_t)__shfl_xor_sync(full_mask, (long long)v, o));
    return v;
}
// Lowest set bit's index, 0 when there is none (jnp.argmax of an all-false
// row); highest set bit's index (m != 0: the last of a select chain).
__device__ __forceinline__ int lowest(unsigned m) { return m ? __ffs(m) - 1 : 0; }
__device__ __forceinline__ int highest(unsigned m) { return 31 - __clz(m); }

// The instances of the step's body (see the kernel): the op classes each
// one serves, and a compile-time tag for each.
enum StepKind { SK_FULL, SK_GENERAL, SK_ALU, SK_BRANCH };
template <int K> struct Kind { static constexpr int value = K; };

// The bits of a packed op-spec word (s_op in the kernel).
enum OpWord { OPW_SHIFT = 33,  // the op-spec word's place in a decode word
              OPW_FLAGS = 8, OPW_MEMC = 12, OPW_PCC = 16, OPW_WB_SP = 20,
              OPW_WB_LR, OPW_ADDR_POST, OPW_WB_BASE, OPW_SEGV, OPW_EXIT,
              OPW_FULL, OPW_ALU, OPW_BRANCH };

// The op-spec columns of op i packed into one word: the alu class in bits
// 0-7, then the OpWord fields; OPW_FULL, OPW_ALU and OPW_BRANCH pick the
// instance of the step's body that serves the op (see the kernel).
__device__ __forceinline__ uint32_t op_word(const MegastepArgs& a, int i) {
    const bool full = a.pcc[i] == P_SVC || a.pcc[i] == P_TRAP
                      || a.segv[i] || a.exit_[i];
    const bool memory = a.memc[i] != M_NONE || a.alu[i] == A_LOAD
                        || a.alu[i] == A_LOAD_B || a.wb_base[i];
    return (uint32_t)a.alu[i] | (uint32_t)a.flags[i] << OPW_FLAGS
        | (uint32_t)a.memc[i] << OPW_MEMC | (uint32_t)a.pcc[i] << OPW_PCC
        | (uint32_t)(a.wb_sp[i] != 0) << OPW_WB_SP
        | (uint32_t)(a.wb_lr[i] != 0) << OPW_WB_LR
        | (uint32_t)(a.addr_post[i] != 0) << OPW_ADDR_POST
        | (uint32_t)(a.wb_base[i] != 0) << OPW_WB_BASE
        | (uint32_t)(a.segv[i] != 0) << OPW_SEGV
        | (uint32_t)(a.exit_[i] != 0) << OPW_EXIT
        | (uint32_t)full << OPW_FULL
        | (uint32_t)(!full && !memory && a.pcc[i] == P_NEXT) << OPW_ALU
        | (uint32_t)(!full && !memory && a.flags[i] == F_NONE && !a.wb_sp[i]
                     && (a.alu[i] == A_NONE || a.alu[i] == A_LINK)
                     && (a.pcc[i] == P_REL || a.pcc[i] == P_IND
                         || a.pcc[i] == P_CBZ || a.pcc[i] == P_CBNZ
                         || a.pcc[i] == P_BCOND)) << OPW_BRANCH;
}

// The decode word of each code word (MegastepArgs::uop): once for a
// carry, before the steps; every code word of every image a thread.
__global__ void megastep_decode_kernel(const MegastepArgs a, const int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t w = a.packed[i];
    int op = (int)(w & 63);
    if (op > N_OPS - 1) op = N_OPS - 1;  // JAX gathers clamp the index
    a.uop[i] = (w & (((int64_t)1 << OPW_SHIFT) - 1))
             | (int64_t)op_word(a, op) << OPW_SHIFT;
}

// The emulated family a lane's svc selects (at most one per step).
enum EmulFam { EF_NONE, EF_OPEN, EF_CLOSE, EF_LSEEK, EF_DUP, EF_FSTAT,
               EF_PIPE, EF_RAND, EF_IOCTL };

// A syscall row's effect for a lane, from its kind and the lane's
// emulation gate (bits of the flags any matching row sets).
enum RowBit { RB_READ = 1, RB_WRITE = 2, RB_GETPID = 4, RB_EXIT = 8,
              RB_SIGRET = 16, RB_KNOWN = 32 };

// The lane's pre-step counters (the ioctl values and the /proc window).
struct LaneView {
    int64_t icount, cycles, hook_count, enosys_count, emul_served, in_off,
        out_count, out_sum, fuel, pid, virt_getpid;
};

struct SvcOut {
    int64_t ret;
    bool is_ret, served, rd_stream, wr_stream;
};

// One guest-kernel service step for one lane, by its warp
// (repro_torch.emul.engine service + run_data_loop, specialised to the one
// syscall this lane executes): fd resolution, errno surface, table updates
// in the lane's k_* rows, the fstat / pipe2 result words and the bulk data
// move.  Thread i loads fd slot i, open-file description i and inode i;
// the scalars come from them by shuffles and ballots.  Thread 0 makes the
// table updates and result words; the data mover is strided over the warp.
// `fam` is the emulated family (EF_NONE for a read or write); the caller
// enters only when a family is set or an enabled lane reads or writes.
__device__ __forceinline__ SvcOut emul_service(
        const MegastepArgs& a, const int64_t lane, const int lid,
        const int fam, const bool sys_read, const bool sys_write,
        const bool en, const int64_t x0, const int64_t x1, const int64_t x2,
        const int64_t path_w, const bool io_ok, const int64_t io_n,
        const LaneView& v) {
    int64_t* fd_ofd = a.leaf[LEAF_k_fd_ofd] + lane * MAX_FDS;
    int64_t* ofd_kind = a.leaf[LEAF_k_ofd_kind] + lane * MAX_FDS;
    int64_t* ofd_ino = a.leaf[LEAF_k_ofd_ino] + lane * MAX_FDS;
    int64_t* ofd_off = a.leaf[LEAF_k_ofd_off] + lane * MAX_FDS;
    int64_t* ofd_flags = a.leaf[LEAF_k_ofd_flags] + lane * MAX_FDS;
    int64_t* ofd_ref = a.leaf[LEAF_k_ofd_ref] + lane * MAX_FDS;
    int64_t* ino_kind = a.leaf[LEAF_k_ino_kind] + lane * MAX_INODES;
    int64_t* ino_name = a.leaf[LEAF_k_ino_name] + lane * MAX_INODES;
    int64_t* ino_size = a.leaf[LEAF_k_ino_size] + lane * MAX_INODES;
    int64_t* rngp = a.leaf[LEAF_k_rng] + lane;
    int64_t* mem = a.leaf[LEAF_mem] + lane * MEM_WORDS;
    const int64_t ipl = MAX_INODES * FILE_WORDS;
    const bool one = lid == 0;  // the writer of the tables and result words

    // -- the lane's tables, one slot a thread (coalesced) -------------------
    const bool f_slot = lid < MAX_FDS, i_slot = lid < MAX_INODES;
    const int64_t my_fd_ofd = f_slot ? fd_ofd[lid] : 0;
    const int64_t my_okind = f_slot ? ofd_kind[lid] : 0;
    const int64_t my_oino = f_slot ? ofd_ino[lid] : 0;
    const int64_t my_ooff = f_slot ? ofd_off[lid] : 0;
    const int64_t my_oflags = f_slot ? ofd_flags[lid] : 0;
    const int64_t my_oref = f_slot ? ofd_ref[lid] : 0;
    const int64_t my_ikind = i_slot ? ino_kind[lid] : 0;
    const int64_t my_iname = i_slot ? ino_name[lid] : 0;
    const int64_t my_isize = i_slot ? ino_size[lid] : 0;
    const int64_t rng0 = *rngp;

    // -- fd resolution (indices clipped before every gather) ----------------
    const int64_t fd = x0;
    const bool fd_inr = fd >= 0 && fd < MAX_FDS;
    const int fdc = (int)clampi(fd, 0, MAX_FDS - 1);
    const int64_t ofd = shfl(my_fd_ofd, fdc);
    const bool fd_valid = fd_inr && ofd >= 0;
    const int ofdc = (int)clampi(ofd, 0, MAX_FDS - 1);
    const int64_t okind = shfl(my_okind, ofdc), oino = shfl(my_oino, ofdc);
    const int64_t ooff = shfl(my_ooff, ofdc), oflags = shfl(my_oflags, ofdc);
    const int64_t oref = shfl(my_oref, ofdc);
    const int inoc = (int)clampi(oino, 0, MAX_INODES - 1);
    const int64_t isize = shfl(my_isize, inoc);

    // -- free slots as ballots: lowest (and second lowest) free slot, 0 when
    // there is none -----------------------------------------------------------
    const unsigned free_fd = __ballot_sync(full_mask, f_slot && my_fd_ofd < 0);
    const unsigned free_ofd = __ballot_sync(full_mask,
                                            f_slot && my_okind == FD_FREE);
    const unsigned free_ino = __ballot_sync(full_mask,
                                            i_slot && my_ikind == INO_FREE);
    const int n_free_fd = __popc(free_fd), n_free_ofd = __popc(free_ofd);
    const int fd_a = lowest(free_fd), fd_b = lowest(free_fd & (free_fd - 1));
    const int ofd_a = lowest(free_ofd);
    const int ofd_b = lowest(free_ofd & (free_ofd - 1));
    const bool has_ino = free_ino != 0;
    const int ino_a = lowest(free_ino);

    SvcOut o;
    o.ret = 0;
    o.is_ret = fam != EF_NONE;
    o.rd_stream = sys_read && (!en || (fd_valid && okind == FD_RSTREAM));
    o.wr_stream = sys_write && (!en || (fd_valid && okind == FD_WSINK));

    // data-mover routing
    bool fio = false, dst_is_mem = false, src_proc = false, src_rand = false;
    int64_t nw = 0, mem_base = 0, ino_base = 0, proc_base = 0;

    switch (fam) {
    case EF_OPEN: {
        const bool pvalid = mem_ok(x1);
        const int64_t name = path_w;
        const bool is_proc = name == PROC_KEY, is_dev = name == DEV_KEY;
        const bool is_file = !is_proc && !is_dev;
        // the reference's loop runs downward, so its last hit is the lowest
        const unsigned hits = __ballot_sync(
            full_mask, i_slot && my_ikind == INO_FILE && my_iname == name);
        const bool exists = hits != 0;
        const int ino_hit = lowest(hits);
        const bool o_creat = (x2 & O_CREAT) != 0, o_excl = (x2 & O_EXCL) != 0;
        const bool o_trunc = (x2 & O_TRUNC) != 0;
        const bool need_create = is_file && !exists;
        int64_t err = 0;
        if (!pvalid) err = -EMUL_EFAULT;
        else if (is_file && !exists && !o_creat) err = -EMUL_ENOENT;
        else if (is_file && exists && o_creat && o_excl) err = -EMUL_EEXIST;
        else if (n_free_fd < 1) err = -EMUL_EMFILE;
        else if (n_free_ofd < 1) err = -EMUL_ENFILE;
        else if (need_create && !has_ino) err = -EMUL_ENOSPC;
        o.ret = err == 0 ? fd_a : err;
        if (err == 0 && one) {
            fd_ofd[fd_a] = ofd_a;
            ofd_kind[ofd_a] = is_proc ? FD_PROC : (is_dev ? FD_DEV : FD_FILE);
            ofd_ino[ofd_a] = need_create ? ino_a : ino_hit;
            ofd_off[ofd_a] = 0;
            ofd_flags[ofd_a] = x2;
            ofd_ref[ofd_a] = 1;
            if (need_create) {
                ino_kind[ino_a] = INO_FILE;
                ino_name[ino_a] = name;
                ino_size[ino_a] = 0;
            } else if (is_file && o_trunc) {  // exists
                ino_size[ino_hit] = 0;
            }
        }
        break;
    }
    case EF_CLOSE:
        o.ret = fd_valid ? 0 : -EMUL_EBADF;
        if (fd_valid && one) {
            fd_ofd[fdc] = -1;
            if (oref <= 1) {
                ofd_kind[ofdc] = FD_FREE;
                ofd_ino[ofdc] = 0;
                ofd_off[ofdc] = 0;
                ofd_flags[ofdc] = 0;
            }
            ofd_ref[ofdc] = wsub(oref, 1) < 0 ? 0 : wsub(oref, 1);
        }
        break;
    case EF_DUP:
        o.ret = !fd_valid ? -EMUL_EBADF : (n_free_fd < 1 ? -EMUL_EMFILE : fd_a);
        if (fd_valid && n_free_fd >= 1 && one) {
            fd_ofd[fd_a] = ofd;
            ofd_ref[ofdc] = wadd(oref, 1);
        }
        break;
    case EF_LSEEK: {
        const bool whence_ok = x2 >= SEEK_SET && x2 <= SEEK_END;
        const int64_t seek_new = x2 == SEEK_SET ? x1
                               : (x2 == SEEK_CUR ? wadd(ooff, x1) : wadd(isize, x1));
        int64_t err = 0;
        if (!fd_valid) err = -EMUL_EBADF;
        else if (okind != FD_FILE) err = -EMUL_ESPIPE;
        else if (!whence_ok) err = -EMUL_EINVAL;
        else if (seek_new < 0) err = -EMUL_EINVAL;
        o.ret = err == 0 ? seek_new : err;
        if (err == 0 && one) ofd_off[ofdc] = seek_new;
        break;
    }
    case EF_FSTAT: {
        const bool sbuf_ok = mem_ok(x1) && wadd(x1, STAT_WORDS * 8) <= MEM_LIMIT;
        const int64_t err = !fd_valid ? -EMUL_EBADF : (!sbuf_ok ? -EMUL_EFAULT : 0);
        o.ret = err;
        if (err == 0 && one) {
            const int64_t size = okind == FD_PROC ? PROC_WORDS * 8
                : ((okind == FD_PIPE_R || okind == FD_PIPE_W || okind == FD_FILE)
                   ? isize : 0);
            int64_t* sb = mem + widx(x1);
            sb[0] = okind;
            sb[1] = oino;
            sb[2] = size;
            sb[3] = 1;
        }
        break;
    }
    case EF_PIPE: {
        const bool pbuf_ok = mem_ok(x0) && wadd(x0, 16) <= MEM_LIMIT;
        int64_t err = 0;
        if (x1 != 0) err = -EMUL_EINVAL;
        else if (!pbuf_ok) err = -EMUL_EFAULT;
        else if (n_free_fd < 2) err = -EMUL_EMFILE;
        else if (n_free_ofd < 2) err = -EMUL_ENFILE;
        else if (!has_ino) err = -EMUL_ENOSPC;
        o.ret = err;
        if (err == 0 && one) {
            fd_ofd[fd_a] = ofd_a;
            fd_ofd[fd_b] = ofd_b;
            ofd_kind[ofd_a] = FD_PIPE_R;
            ofd_kind[ofd_b] = FD_PIPE_W;
            ofd_ino[ofd_a] = ino_a;
            ofd_ino[ofd_b] = ino_a;
            ofd_off[ofd_a] = 0;
            ofd_off[ofd_b] = 0;
            ofd_flags[ofd_a] = 0;
            ofd_flags[ofd_b] = 0;
            ofd_ref[ofd_a] = 1;
            ofd_ref[ofd_b] = 1;
            ino_kind[ino_a] = INO_PIPE;
            ino_name[ino_a] = 0;
            ino_size[ino_a] = 0;
            int64_t* pb = mem + widx(x0);
            pb[0] = fd_a;
            pb[1] = fd_b;
        }
        break;
    }
    case EF_RAND: {
        const int64_t rand_n = clampi(x1, 0, FILE_BYTES);
        int64_t err = 0;
        if (x1 < 0 || (x1 & 7) != 0) err = -EMUL_EINVAL;
        else if (!(mem_ok(x0) && wadd(x0, rand_n) <= MEM_LIMIT)) err = -EMUL_EFAULT;
        o.ret = err == 0 ? rand_n : err;
        if (err == 0) {
            if (one) *rngp = wadd(rng0, rand_n >> 3);
            nw = rand_n >> 3;
            fio = nw > 0;
            dst_is_mem = src_rand = true;
            mem_base = lane * MEM_WORDS + widx(x0);
        }
        break;
    }
    case EF_IOCTL: {
        const int64_t val = x1 == ASC_IOCTL_ICOUNT ? v.icount
                          : x1 == ASC_IOCTL_HOOKS ? v.hook_count
                          : x1 == ASC_IOCTL_PID ? v.pid : -EMUL_EINVAL;
        o.ret = !fd_valid ? -EMUL_EBADF : (okind != FD_DEV ? -EMUL_ENOTTY : val);
        break;
    }
    default:
        break;
    }

    if (sys_read && en) {  // file / proc / pipe / device reads
        const bool rd_data = fd_valid && (okind == FD_FILE || okind == FD_PROC
                                          || okind == FD_PIPE_R);
        const bool rd_dev = fd_valid && okind == FD_DEV;
        if (!o.rd_stream) {  // rd_data, rd_dev or a bad fd / wrong direction
            o.is_ret = true;
            const int64_t src_size = okind == FD_PROC ? PROC_WORDS * 8 : isize;
            const int64_t err = !io_ok ? -EMUL_EFAULT : ((ooff & 7) != 0 ? -EMUL_EINVAL : 0);
            int64_t rd_n = wsub(src_size, ooff);
            rd_n = io_n < rd_n ? io_n : rd_n;
            rd_n = rd_n < 0 ? 0 : rd_n;
            o.ret = rd_data ? (err == 0 ? rd_n : err) : (rd_dev ? 0 : -EMUL_EBADF);
            if (rd_data && err == 0) {
                if (one) ofd_off[ofdc] = wadd(ooff, rd_n);
                nw = rd_n >> 3;
                fio = nw > 0;
                dst_is_mem = true;
                src_proc = okind == FD_PROC;
                mem_base = lane * MEM_WORDS + widx(x1);
                const int64_t ow = ooff >> 3;
                ino_base = lane * ipl + inoc * FILE_WORDS + clampi(ow, 0, FILE_WORDS - 1);
                proc_base = lane * PROC_WORDS + clampi(ow, 0, PROC_WORDS - 1);
            }
        }
    }
    if (sys_write && en) {  // file / pipe / device writes
        const bool wr_data = fd_valid && (okind == FD_FILE || okind == FD_PIPE_W);
        const bool wr_dev = fd_valid && okind == FD_DEV;
        if (!o.wr_stream) {
            o.is_ret = true;
            const bool w_is_pipe = okind == FD_PIPE_W;
            const int64_t w_off = (w_is_pipe || (oflags & O_APPEND) != 0) ? isize : ooff;
            const int64_t w_end = wadd(w_off, io_n);
            int64_t err = 0;
            if (!io_ok) err = -EMUL_EFAULT;
            else if ((w_off & 7) != 0) err = -EMUL_EINVAL;
            else if (w_end > FILE_BYTES) err = w_is_pipe ? -EMUL_EAGAIN : -EMUL_EFBIG;
            o.ret = wr_data ? (err == 0 ? io_n : err)
                  : (wr_dev ? (io_ok ? io_n : -EMUL_EFAULT) : -EMUL_EBADF);
            if (wr_data && err == 0) {
                if (one) {
                    if (!w_is_pipe) ofd_off[ofdc] = w_end;
                    ino_size[inoc] = w_is_pipe ? w_end : (isize > w_end ? isize : w_end);
                }
                nw = io_n >> 3;
                fio = nw > 0;
                mem_base = lane * MEM_WORDS + widx(x1);
                ino_base = lane * ipl + inoc * FILE_WORDS
                         + clampi(w_off >> 3, 0, FILE_WORDS - 1);
            }
        }
    }
    o.served = o.is_ret || (en && (o.rd_stream || o.wr_stream));

    // -- the data mover (run_data_loop): whole-plane index arithmetic, word
    // j by thread j % 32.  Source and destination are different planes, so
    // the words move in any order with the sequential loop's result. ------
    if (fio) {
        int64_t* mem_plane = a.leaf[LEAF_mem];
        int64_t* ino_plane = a.leaf[LEAF_k_ino_data];
        const int64_t mtot = a.n_lanes * MEM_WORDS;
        const int64_t itot = a.n_lanes * ipl;
        const int64_t ptot = a.n_lanes * PROC_WORDS;
        if (dst_is_mem) {
            const uint64_t stream = splitmix64((uint64_t)rng0 * 0x10001ull + 1ull);
            const int64_t pid_word = v.virt_getpid != 0 ? VIRT_PID : v.pid;
            for (int64_t j = lid; j < nw; j += 32) {
                int64_t val;
                if (src_rand) {
                    val = (int64_t)splitmix64(stream + (uint64_t)j);
                } else if (src_proc) {
                    // the lane's own /proc row, from the pre-step counters
                    const int64_t w = clampi(proc_base + j, 0, ptot - 1) - lane * PROC_WORDS;
                    val = w == 0 ? pid_word : w == 1 ? v.icount : w == 2 ? v.cycles
                        : w == 3 ? v.hook_count : w == 4 ? v.enosys_count
                        : w == 5 ? v.emul_served : w == 6 ? v.in_off
                        : w == 7 ? v.out_count : w == 8 ? v.out_sum
                        : w == 9 ? v.fuel : 0;
                } else {
                    val = ino_plane[clampi(ino_base + j, 0, itot - 1)];
                }
                const int64_t d = mem_base + j;
                if (d < mtot) mem_plane[d] = val;
            }
        } else {
            for (int64_t j = lid; j < nw; j += 32) {
                const int64_t d = ino_base + j;
                if (d < itot) ino_plane[d] = mem_plane[clampi(mem_base + j, 0, mtot - 1)];
            }
        }
    }
    return o;
}

// The policy gate (K2) for one lane's svc: the action for `nr` from the
// lane's policy row.  Thread i holds row i's action and argument; `match`
// is the ballot of the syscall rows whose number is `nr`; a later row wins
// (the JAX select chain), none leaves SLOT_UNKNOWN's.
struct Verdict {
    int64_t pol_arg, slot;
    bool exec, deny, emul, kill, emul_const;
};

__device__ __forceinline__ Verdict policy_gate(const unsigned match,
                                               const unsigned emul_match,
                                               const int64_t my_action,
                                               const int64_t my_arg,
                                               const bool en) {
    const int slot = match ? highest(match) : SLOT_UNKNOWN;
    const int64_t action = shfl(my_action, slot);
    Verdict v;
    v.pol_arg = shfl(my_arg, slot);
    v.slot = slot;
    const bool emulable = emul_match != 0;
    v.deny = action == POL_DENY;
    v.emul = action == POL_EMULATE;
    v.kill = action == POL_KILL;
    // EMULATE on a guest-kernel-backed nr routes into the emulation service
    const bool emul_route = v.emul && emulable && en;
    v.emul_const = v.emul && !(emulable && en);
    v.exec = action == POL_ALLOW || emul_route;
    return v;
}

__global__ void megastep_kernel(const MegastepArgs a) {
    // The op-spec words (the decode words carry them; a null-page fetch
    // reads OP_NULLPAGE's here), the signal numbers, costs and b.cond masks.
    __shared__ uint32_t s_op[N_OPS];
    __shared__ int64_t s_signo[N_OPS], s_cost[N_OPS], s_cond[16];
    for (int i = threadIdx.x; i < N_OPS; i += blockDim.x) {
        s_op[i] = op_word(a, i);
        s_signo[i] = a.signo[i];
        s_cost[i] = a.cost[i];
    }
    for (int i = threadIdx.x; i < 16; i += blockDim.x) s_cond[i] = a.cond_mask[i];
    __syncthreads();

    const int lid = threadIdx.x & 31;
    const int64_t lane = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (lane >= a.n_lanes) return;  // the ragged edge of the last block
    const bool one = lid == 0;      // the writer of single words

    // -- load the lane's carry: x_i in thread i, the scalars in every thread
    int64_t* regs_p = a.leaf[LEAF_regs] + lane * 31;
    int64_t x = lid < 31 ? regs_p[lid] : 0;
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
    const int64_t virt_getpid = a.leaf[LEAF_virt_getpid][lane];
    const bool virt = in_pt && virt_getpid != 0;
    int64_t hook_count = a.leaf[LEAF_hook_count][lane];
    const int64_t pid = a.leaf[LEAF_pid][lane];
    int64_t in_off = a.leaf[LEAF_in_off][lane];
    int64_t out_count = a.leaf[LEAF_out_count][lane];
    int64_t out_sum = a.leaf[LEAF_out_sum][lane];
    int64_t enosys_count = a.leaf[LEAF_enosys_count][lane];
    int64_t emul_served = a.leaf[LEAF_emul_served][lane];
    const bool en = a.leaf[LEAF_k_enabled][lane] != 0;
    int64_t* mem = a.leaf[LEAF_mem] + lane * MEM_WORDS;
    const int64_t img_row = __ldg(a.ids + lane);
    const int64_t* __restrict__ code = a.uop + img_row * CODE_WORDS;
    const int64_t* __restrict__ imms = a.imm + img_row * CODE_WORDS;

    // -- the syscall rows, row i in thread i, resolved for this lane's
    // emulation gate.  Emulation off: openat / close return their
    // historical constants and the other emulated kinds fall through to
    // -ENOSYS.
    const bool row_ok = lid < N_SYSCALLS;
    const int64_t my_nr = row_ok ? a.sys_nr[lid] : 0;
    const int64_t my_const = row_ok ? a.sys_const[lid] : 0;
    const bool my_emulable = row_ok && a.sys_emul[lid] != 0;
    unsigned my_bits = 0;
    bool my_sets_const = false;
    int my_fam = EF_NONE;
    if (row_ok) {
        const int64_t kind = a.sys_kind[lid];
        if (kind == K_IO_READ) my_bits = RB_READ | RB_KNOWN;
        else if (kind == K_IO_WRITE) my_bits = RB_WRITE | RB_KNOWN;
        else if (kind == K_GETPID) my_bits = RB_GETPID | RB_KNOWN;
        else if (kind == K_EXIT) my_bits = RB_EXIT | RB_KNOWN;
        else if (kind == K_SIGRETURN) my_bits = RB_SIGRET | RB_KNOWN;
        else if (kind == K_OPENAT || kind == K_CLOSE) {
            my_bits = RB_KNOWN;
            if (en) my_fam = kind == K_OPENAT ? EF_OPEN : EF_CLOSE;
            else my_sets_const = true;
        } else if (kind == K_CONST) {
            my_bits = RB_KNOWN;
            my_sets_const = true;
        } else if (en) {  // the emulation-only kinds
            my_bits = RB_KNOWN;
            my_fam = kind == K_LSEEK ? EF_LSEEK : kind == K_DUP ? EF_DUP
                   : kind == K_FSTAT ? EF_FSTAT : kind == K_PIPE2 ? EF_PIPE
                   : kind == K_GETRANDOM ? EF_RAND : EF_IOCTL;
        }
    }

    // -- the trace carry (K2): the policy rows, slot i in thread i; the
    // lane's trace scalars, written back at the end ------------------------
    const bool traced = a.trace_cap > 0;
    int64_t my_action = 0, my_arg = 0;
    int64_t t_count = 0, t_hot = 0, t_base = 0, t_deny = 0, t_emul = 0, t_kill = 0;
    if (traced) {
        if (lid < N_POLICY_SLOTS) {
            my_action = ((const int32_t*)a.tleaf[TLEAF_pol_action])[lane * N_POLICY_SLOTS + lid];
            my_arg = a.tleaf[TLEAF_pol_arg][lane * N_POLICY_SLOTS + lid];
        }
        t_count = a.tleaf[TLEAF_count][lane];
        t_hot = a.tleaf[TLEAF_hot][lane];
        t_base = a.tleaf[TLEAF_base][lane];
        t_deny = a.tleaf[TLEAF_deny_count][lane];
        t_emul = a.tleaf[TLEAF_emul_count][lane];
        t_kill = a.tleaf[TLEAF_kill_count][lane];
    }
    const int64_t cap = a.trace_cap;
    const int64_t nrows = a.n_lanes * 2 * cap;

    // A lane that is not live stays not live for the rest of the chunk
    // (halted never returns to RUNNING) and masked steps are the identity,
    // so it stops early: a live lane runs min(chunk, fuel - icount) steps
    // (icount grows by one a step) unless it halts first.
    int64_t n_steps = 0;
    if (halted == RUNNING && icount < fuel) {
        const uint64_t room = (uint64_t)fuel - (uint64_t)icount;
        n_steps = room < (uint64_t)a.chunk ? (int64_t)room : a.chunk;
    }
    for (int64_t t = 0; t < n_steps; ++t) {
        if (halted != RUNNING) break;
        const int64_t pc0 = pc, sp0 = sp, nzcv0 = nzcv;

        // -- fetch + decode ------------------------------------------------
        const bool ok_fetch = pc0 >= 0 && pc0 < CODE_LIMIT && (pc0 & 3) == 0;
        const int64_t fi = clampi(pc0 >> 2, 0, CODE_WORDS - 1);
        const int64_t w = __ldg(code + fi), imm = __ldg(imms + fi);
        int op = (int)(w & 63);
        if (op > N_OPS - 1) op = N_OPS - 1;  // JAX gathers clamp the index
        uint32_t opw = (uint32_t)(w >> OPW_SHIFT);
        if (!ok_fetch) {
            op = OP_NULLPAGE;
            opw = s_op[OP_NULLPAGE];
        }
        const int rd = (int)((w >> 6) & 31);
        const int rn = (int)((w >> 11) & 31);
        const int rm = (int)((w >> 16) & 31);
        const int sh = (int)((w >> 22) & 63);
        const int cond = (int)((w >> 28) & 15);
        const int sf = (int)((w >> 32) & 1);

        const int64_t op_cost = s_cost[op], cond_mask = s_cond[cond];
        const int op_aluc = opw & 255, op_flagc = (opw >> OPW_FLAGS) & 15;
        const int op_memc = (opw >> OPW_MEMC) & 15, op_pcc = (opw >> OPW_PCC) & 15;
        const bool op_wb_sp = (opw >> OPW_WB_SP) & 1, wb_lr = (opw >> OPW_WB_LR) & 1;
        const bool addr_post = (opw >> OPW_ADDR_POST) & 1;
        const bool op_wb_base = (opw >> OPW_WB_BASE) & 1;
        const bool op_svc = op_pcc == P_SVC;
        const bool op_null = (opw >> OPW_SEGV) & 1;
        const bool op_hlt = (opw >> OPW_EXIT) & 1;
        const bool op_trap = op_pcc == P_TRAP;

        // The rest of the step, compiled four times, each instance for the
        // op classes the decode word marks: in full for an svc, a trap, a
        // halt or a null-page fetch; without those paths for loads, stores
        // and any other op (SK_GENERAL); without memory for ops that go on
        // to the next instruction (SK_ALU: ALU and moves); without memory,
        // flags or ALU classes but the link for branches (SK_BRANCH).  The
        // lean instances are a fraction of the full step's code.
        auto step = [&](auto instance) {
            constexpr int kind = decltype(instance)::value;
            constexpr bool whole = kind == SK_FULL;
            constexpr bool mem_op = whole || kind == SK_GENERAL;
            const bool m_svc = whole && op_svc;
            const bool m_null = whole && op_null;
            const bool m_hlt = whole && op_hlt;
            const bool dlv = whole && op_trap;
            const int memc = mem_op ? op_memc : M_NONE;
            const int pcc = kind == SK_ALU ? P_NEXT : op_pcc;
            const int aluc = kind != SK_BRANCH ? op_aluc
                           : (op_aluc == A_LINK ? A_LINK : A_NONE);
            const int flagc = kind == SK_BRANCH ? F_NONE : op_flagc;
            const bool wb_base = mem_op && op_wb_base;
            const bool wb_sp = kind != SK_BRANCH && op_wb_sp;
            const bool ld_single = memc == M_LOAD, st_single = memc == M_STORE;
            const bool ld_pair = memc == M_LOAD_P, st_pair = memc == M_STORE_P;
            const bool st_byte = memc == M_STORE_BYTE;
            const bool byte_op = memc == M_LOAD_BYTE || st_byte;

            // -- register reads by shuffle (reg 31 is XZR for _rr, SP for _rsp;
            // the reference reads r[min(reg, 30)] before the select) -----------
            const int ra = (int)clampi(imm, 0, 31);  // madd packs ra into imm
            const int64_t rn_raw = shfl(x, rn < 30 ? rn : 30);
            // (a branch reads no rm and no ra)
            const int64_t rm_raw = kind == SK_BRANCH ? 0 : shfl(x, rm < 30 ? rm : 30);
            const int64_t rd_raw = shfl(x, rd < 30 ? rd : 30);
            const int64_t ra_raw = kind == SK_BRANCH ? 0 : shfl(x, ra < 30 ? ra : 30);
            const int64_t rn_rr = rn == 31 ? 0 : rn_raw;
            const int64_t rn_rsp = rn == 31 ? sp0 : rn_raw;
            const int64_t rm_rr = rm == 31 ? 0 : rm_raw;
            const int64_t rd_rr = rd == 31 ? 0 : rd_raw;
            const int64_t ra_rr = ra == 31 ? 0 : ra_raw;
            // the syscall arguments: read on svc and halt steps only
            int64_t x0 = 0, x1 = 0, x2 = 0, nr = 0;
            if (m_svc || m_hlt) {
                x0 = shfl(x, 0);
                x1 = shfl(x, 1);
                x2 = shfl(x, 2);
                nr = shfl(x, 8);
            }
            const int64_t io_buf = x1, io_n = x2;

            // -- memory addressing ---------------------------------------------
            const int64_t addr_a = addr_post ? rn_rsp : wadd(rn_rsp, imm);
            const int64_t eff1 = byte_op ? (addr_a & ~(int64_t)7) : addr_a;
            const bool ok1 = byte_op ? (addr_a >= DATA_BASE && addr_a < MEM_LIMIT)
                                     : mem_ok(eff1);
            const int64_t addr2 = wadd(addr_a, 8);
            const bool ok2 = mem_ok(addr2);
            const int64_t g1 = widx(eff1), g2 = widx(addr2);
            // Reads come from the pre-store memory (every thread loads the same
            // word: one transaction).  The words are consumed only by
            // memory-class ops, so other ops skip the loads.
            int64_t v1 = 0, v2 = 0;
            if (mem_op && (memc != M_NONE || aluc == A_LOAD || aluc == A_LOAD_B))
                v1 = mem[g1];
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

            // -- the syscall rows matching nr: one ballot ----------------------
            unsigned match = 0, emul_match = 0;
            if (m_svc) {
                match = __ballot_sync(full_mask, row_ok && nr == my_nr);
                emul_match = __ballot_sync(full_mask, row_ok && nr == my_nr && my_emulable);
            }

            // -- the policy gate (K2): only ALLOW lanes and EMULATE lanes routed
            // into the guest kernel reach the syscall branches -----------------
            Verdict pv;
            pv.pol_arg = 0;
            pv.slot = SLOT_UNKNOWN;
            pv.exec = m_svc;
            pv.deny = pv.emul = pv.kill = pv.emul_const = false;
            if (traced && m_svc) pv = policy_gate(match, emul_match, my_action, my_arg, en);
            const bool svc_exec = pv.exec;

            // -- syscalls: the matching rows' flags OR'd, the last matching row's
            // constant and family (the reference's loop over the rows) ---------
            bool sys_read = false, sys_write = false, sys_getpid = false;
            bool sys_exit = false, sys_sigret = false, sys_const = false;
            bool known = false;
            int fam = EF_NONE;
            int64_t const_val = 0;
            if (svc_exec) {
                const bool mine = ((match >> lid) & 1) != 0;
                const unsigned bits = __reduce_or_sync(full_mask, mine ? my_bits : 0u);
                const unsigned cm = __ballot_sync(full_mask, mine && my_sets_const);
                const unsigned fm = __ballot_sync(full_mask, mine && my_fam != EF_NONE);
                sys_read = (bits & RB_READ) != 0;
                sys_write = (bits & RB_WRITE) != 0;
                sys_getpid = (bits & RB_GETPID) != 0;
                sys_exit = (bits & RB_EXIT) != 0;
                sys_sigret = (bits & RB_SIGRET) != 0;
                known = (bits & RB_KNOWN) != 0;
                sys_const = cm != 0;
                const_val = shfl(my_const, cm ? highest(cm) : 0);
                if (!cm) const_val = 0;
                fam = __shfl_sync(full_mask, my_fam, fm ? highest(fm) : 0);
                if (!fm) fam = EF_NONE;
            }
            const bool sys_enosys = svc_exec && !known;
            const bool sys_io = sys_read || sys_write;

            const int64_t io_k = clampi(io_n >> 3, 0, MAX_IO_WORDS);
            const bool io_ok = mem_ok(io_buf) && wadd(io_buf, io_n) <= MEM_LIMIT
                               && io_n >= 0 && (io_n & 7) == 0;
            const int64_t io_start = widx(io_buf);
            // the openat path word, from the pre-store memory
            const int64_t path_w = fam == EF_OPEN ? mem[widx(x1)] : 0;

            // -- guest-kernel service (K3) ---------------------------------------
            SvcOut eo;
            eo.ret = 0;
            eo.is_ret = eo.served = false;
            eo.rd_stream = sys_read;
            eo.wr_stream = sys_write;
            const bool serviced = fam != EF_NONE || (sys_io && en);
            if (serviced) {
                const LaneView view = {icount, cycles, hook_count, enosys_count,
                                       emul_served, in_off, out_count, out_sum,
                                       fuel, pid, virt_getpid};
                eo = emul_service(a, lane, lid, fam, sys_read, sys_write, en, x0,
                                  x1, x2, path_w, io_ok, io_n, view);
            }
            const bool io_stream = eo.rd_stream || eo.wr_stream;

            int64_t svc_x0 = 0;
            if (io_stream) svc_x0 = io_ok ? io_n : -EMUL_EFAULT;
            else if (eo.is_ret) svc_x0 = eo.ret;
            else if (sys_getpid) svc_x0 = virt ? VIRT_PID : pid;
            else if (sys_const) svc_x0 = const_val;
            else if (sys_enosys) svc_x0 = -EMUL_ENOSYS;
            bool svc_x0_en = svc_exec && !(sys_exit || sys_sigret);
            if (pv.deny) svc_x0 = wsub(0, pv.pol_arg);
            else if (pv.emul_const) svc_x0 = pv.pol_arg;
            svc_x0_en = svc_x0_en || pv.deny || pv.emul_const;

            // -- signal delivery -------------------------------------------------
            const bool can_sig = dlv && sig_handler != 0 && in_signal == 0;
            const bool trap_fail = dlv && !can_sig;

            // -- memory writes, in the JAX order: (the service's,) stores,
            // sigframe push, stream I/O ------------------------------------------
            // JAX parks disabled stores at out-of-range indices and drops them;
            // here a disabled store is simply not made.  A pair store whose
            // second word faults keeps its first.
            const bool stores = (st_single || st_pair || st_byte) && ok1;
            if (serviced && (stores || can_sig)) __syncwarp();
            if (one) {
                if (stores) mem[g1] = byte_op ? strb_word : rd_rr;
                if (st_pair && ok2) mem[g2] = rm_rr;
            }
            if (can_sig) {  // the frame saves the PRE-step registers and flags
                if (stores) __syncwarp();
                int64_t* f = mem + SIGFRAME_IDX;
                f[lid] = lid < 31 ? x : sp0;
                if (lid < 2) f[32 + lid] = lid == 0 ? pc0 : nzcv0;
            }
            // Stream I/O: words [io_start, io_start + io_k) of the lane — the
            // net effect of the JAX engine's clamped 512-word windows (io_ok
            // keeps the span inside the lane), word j by thread j % 32.  The
            // write sum reads memory after the stores.
            int64_t io_sum = 0;
            if (io_stream && io_ok) {
                __syncwarp();
                int64_t* p = mem + io_start;
                if (sys_read) {
                    for (int64_t j = lid; j < io_k; j += 32) p[j] = wadd(in_off, j * 8);
                } else {
                    int64_t part = 0;
                    for (int64_t j = lid; j < io_k; j += 32) part = wadd(part, p[j]);
                    io_sum = warp_sum(part);
                }
            }

            // -- register writes (slot order of the JAX executor; a later write
            // wins), as selects: register 31 is thread 31's, which holds
            // nothing, so a write to it is dropped as the reference drops it
            // (or goes to SP) ------------------------------------------------------
            const int idx = wb_lr ? 30 : rd;
            const bool primary = aluc != A_NONE;
            x = (primary && lid == idx) ? slot_val : x;
            sp = (primary && idx == 31 && wb_sp) ? slot_val : sp;  // _wsp ops
            x = (ld_pair && lid == rm) ? ld2 : x;
            const int64_t base_v = wadd(rn_rsp, imm);
            x = (wb_base && lid == rn) ? base_v : x;
            sp = (wb_base && rn == 31) ? base_v : sp;
            if (svc_x0_en && lid == 0) x = svc_x0;
            if (can_sig) {
                if (lid == 0) x = s_signo[op];
                if (lid == 1) x = SIGFRAME;
                sp = SIGSTACK_TOP;
            }
            int64_t frame_pc = 0, frame_x0 = 0;
            if (sys_sigret) {  // the frame is read from the FINAL memory
                __syncwarp();
                const int64_t* f = mem + SIGFRAME_IDX;
                const int64_t mine = f[lid];
                if (lid < 31) x = mine;
                sp = f[31];
                frame_pc = f[32];
                nzcv = f[33];
                frame_x0 = f[0];
            }

            // -- program counter (b.cond tests the OLD flags) --------------------
            const int64_t br = wadd(pc0, imm), pc4 = wadd(pc0, 4);
            switch (pcc) {
                case P_REL: pc = br; break;
                case P_IND: pc = rn_rr; break;
                case P_CBZ: pc = rd_rr == 0 ? br : pc4; break;
                case P_CBNZ: pc = rd_rr != 0 ? br : pc4; break;
                case P_BCOND: pc = ((cond_mask >> (nzcv0 & 15)) & 1) ? br : pc4; break;
                case P_STAY: pc = pc0; break;
                case P_TRAP: pc = can_sig ? sig_handler : pc0; break;
                case P_SVC:  // KILL parks like exit
                    pc = (sys_exit || pv.kill) ? pc0
                       : (sys_sigret ? wadd(frame_pc, 4) : pc4);
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
            if (pv.kill) {
                halted = HALT_KILL;
                fault_pc = pc0;
            }

            // -- trace record (word j by thread j), histogram and verdict
            // counters (K2): the record goes to row hot*cap + (count - base) %
            // cap of the lane's ring (JAX's flooring %, and mode="drop"
            // indexing: a negative row counts from the end) ----------------------
            if (traced && m_svc) {
                const int64_t verdict = pv.deny ? POL_DENY : pv.emul ? POL_EMULATE
                    : pv.kill ? POL_KILL : sys_enosys ? VERDICT_UNKNOWN : POL_ALLOW;
                int64_t pos = wadd(wadd(lane * 2 * cap, wmul(t_hot, cap)),
                                   floor_mod(wsub(t_count, t_base), cap));
                if (pos < 0) pos = wadd(pos, nrows);
                if (pos >= 0 && pos < nrows && lid < REC_WORDS) {
                    const int64_t ret = pv.deny ? wsub(0, pv.pol_arg)
                        : pv.emul_const ? pv.pol_arg : pv.kill ? 0
                        : sys_exit ? x0 : sys_sigret ? frame_x0 : svc_x0;
                    const int64_t word = lid == 0 ? icount : lid == 1 ? pc0
                        : lid == 2 ? nr : lid == 3 ? x0 : lid == 4 ? x1
                        : lid == 5 ? x2 : lid == 6 ? ret : verdict;
                    a.tleaf[TLEAF_buf][pos * REC_WORDS + lid] = word;
                }
                if (one) {
                    int64_t* h = a.tleaf[TLEAF_hist]
                        + (lane * N_POLICY_SLOTS + pv.slot) * N_VERDICTS + verdict;
                    *h = wadd(*h, 1);
                }
                t_count = wadd(t_count, 1);
                if (pv.deny) t_deny = wadd(t_deny, 1);
                else if (pv.emul) t_emul = wadd(t_emul, 1);
                else if (pv.kill) t_kill = wadd(t_kill, 1);
            }

            // -- bookkeeping -----------------------------------------------------
            cycles = wadd(cycles, op_cost);
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
            if (eo.rd_stream && io_ok) in_off = wadd(in_off, io_n);
            if (eo.wr_stream && io_ok) {
                out_count = wadd(out_count, io_n);
                out_sum = wadd(out_sum, io_sum);
            }
            if (can_sig) in_signal = 1;
            else if (sys_sigret) in_signal = 0;
            if (sys_enosys) enosys_count = wadd(enosys_count, 1);
            if (eo.served) emul_served = wadd(emul_served, 1);
            // this step's writes before the next step's reads by other threads
            if (stores || serviced || can_sig || (io_stream && io_ok)) __syncwarp();
        };
        if ((opw >> OPW_ALU) & 1) step(Kind<SK_ALU>());
        else if ((opw >> OPW_BRANCH) & 1) step(Kind<SK_BRANCH>());
        else if ((opw >> OPW_FULL) & 1) step(Kind<SK_FULL>());
        else step(Kind<SK_GENERAL>());
    }

    // -- merged writeback: the registers in one coalesced store, the
    // scalars by thread 0 ------------------------------------------------------
    if (lid < 31) regs_p[lid] = x;
    if (!one) return;
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
    a.leaf[LEAF_emul_served][lane] = emul_served;
    if (traced) {
        a.tleaf[TLEAF_count][lane] = t_count;
        a.tleaf[TLEAF_deny_count][lane] = t_deny;
        a.tleaf[TLEAF_emul_count][lane] = t_emul;
        a.tleaf[TLEAF_kill_count][lane] = t_kill;
    }
}

// The kernel's registers, local memory and the most threads a block may
// have with them (so the most lanes a block is that over 32).
extern "C" int megastep_info(int* regs, int* local_bytes, int* max_threads) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, megastep_kernel);
    if (e != cudaSuccess) return (int)e;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    *max_threads = fa.maxThreadsPerBlock;
    return 0;
}

// Fill args->uop from args->packed (once for a carry, before its launches)
// on `stream`; no synchronisation.  Returns cudaGetLastError().
extern "C" int megastep_decode(const MegastepArgs* args, int64_t n_words,
                               void* stream) {
    const int threads = 256;
    const int64_t grid = (n_words + threads - 1) / threads;
    megastep_decode_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
        *args, n_words);
    return (int)cudaGetLastError();
}

// Launch on `stream` (PyTorch's current stream), `block` lanes (warps) a
// block; no synchronisation.  Returns cudaGetLastError() so the wrapper can
// raise on a refused launch (a block of more warps than the kernel's
// registers allow is refused: cudaErrorInvalidConfiguration).
extern "C" int megastep_launch(const MegastepArgs* args, int block, void* stream) {
    static int max_threads = 0;
    if (max_threads == 0) {
        int regs, local_bytes;
        const int e = megastep_info(&regs, &local_bytes, &max_threads);
        if (e != 0) return e;
    }
    if (block < 1 || 32 * block > max_threads) return (int)cudaErrorInvalidConfiguration;
    const int64_t grid = (args->n_lanes + block - 1) / block;
    megastep_kernel<<<(unsigned)grid, 32 * block, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}
