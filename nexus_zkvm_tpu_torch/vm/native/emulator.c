/* Native RV32IM trace-pass emulator.
 *
 * C implementation of the Python LinearEmulator hot loop
 * (nexus_zkvm_tpu/vm/emulator.py) — semantics must match it exactly;
 * golden tests compare full struct-of-arrays traces.  Counterpart of
 * the reference's Rust executor core
 * (nexus-zkvm/vm/src/emulator/executor.rs:749-1115).
 *
 * The caller (ctypes wrapper) provides:
 *   - flat memory image + per-byte mode map (0=NA 1=RO 2=RW 3=WO),
 *   - decoded-program cache arrays (opcode/itype/rd/rs1/rs2/imm per word),
 *   - pre-allocated SoA output arrays of capacity `cap`,
 *   - a private-input tape and a log byte sink.
 *
 * Returns the number of executed steps, or negative error codes:
 *   -1 capacity exhausted, -2 VM fault (bad fetch/access/syscall),
 *   -3 step limit reached without exit.
 * On success *exit_code_out holds the guest exit code.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define MODE_NA 0
#define MODE_RO 1
#define MODE_RW 2
#define MODE_WO 3

/* itype encoding mirrors vm/isa.py InstrType */
#define T_R 0
#define T_I 1
#define T_S 2
#define T_B 3
#define T_U 4
#define T_J 5
#define T_SYS 6
#define T_UNIMPL 7
#define T_CUSTOM 8

/* opcode ids mirror vm/isa.py Opcode */
enum {
    OP_ADD, OP_SUB, OP_SLL, OP_SLT, OP_SLTU, OP_XOR, OP_SRL, OP_SRA,
    OP_OR, OP_AND, OP_MUL, OP_MULH, OP_MULHSU, OP_MULHU, OP_DIV,
    OP_DIVU, OP_REM, OP_REMU, OP_ADDI, OP_SLLI, OP_SLTI, OP_SLTIU,
    OP_XORI, OP_SRLI, OP_SRAI, OP_ORI, OP_ANDI, OP_LB, OP_LH, OP_LW,
    OP_LBU, OP_LHU, OP_JALR, OP_ECALL, OP_EBREAK, OP_FENCE, OP_SB,
    OP_SH, OP_SW, OP_BEQ, OP_BNE, OP_BLT, OP_BGE, OP_BLTU, OP_BGEU,
    OP_LUI, OP_AUIPC, OP_JAL, OP_UNIMPL, OP_KECCAKF = 64
};

typedef struct {
    /* memory */
    uint8_t *mem;          /* [mem_end] */
    uint8_t *mode;         /* [mem_end] */
    uint32_t mem_end;
    /* decoded program cache (index = (pc - prog_start) / 4) */
    uint32_t prog_start, prog_end;
    const uint8_t *p_opc;
    const uint8_t *p_type;
    const uint8_t *p_rd, *p_rs1, *p_rs2;
    const uint32_t *p_imm;
    const uint32_t *p_word;
    /* layout constants */
    uint32_t exit_addr, heap_start, stack_top;
    /* io */
    const uint8_t *priv;
    uint32_t priv_len, priv_pos;
    uint8_t *log_buf;
    uint32_t log_cap, log_len;
    uint32_t *log_splits;      /* message end offsets */
    uint32_t log_splits_cap, n_logs;
    /* memory-check state */
    uint32_t *ram_ts;          /* [mem_end/4] last access clk per word */
    uint64_t reg_ts[32];
    uint32_t regs[32];
    /* stats (discovery mode) */
    uint32_t max_heap, min_stack;
} vm_t;

typedef struct {
    uint32_t *clk, *pc, *next_pc, *word, *imm;
    uint8_t *opcode, *rd, *rs1, *rs2, *rd_written;
    uint32_t *a_val, *b_val, *c_val, *a_prev;
    uint32_t *ts1_prev, *ts2_prev, *ts3_prev;
    uint32_t *mem_addr, *mem_val, *mem_prev_val, *mem_new, *mem_prev_ts;
    uint8_t *mem_size, *mem_store;
} soa_t;

static inline int32_t s32(uint32_t x) { return (int32_t)x; }

static int mem_check(vm_t *vm, uint32_t addr, uint32_t size, int write)
{
    if (addr % size || addr + size > vm->mem_end) return 0;
    uint8_t m = vm->mode[addr];
    if (write) return m == MODE_RW || m == MODE_WO;
    return m == MODE_RO || m == MODE_RW;
}

static inline uint32_t mem_load(vm_t *vm, uint32_t addr, uint32_t size)
{
    uint32_t v = 0;
    memcpy(&v, vm->mem + addr, size);      /* little-endian host */
    return v;
}

static inline void track(vm_t *vm, uint32_t addr)
{
    uint32_t sp = vm->regs[2];
    if (addr >= sp) { if (addr < vm->min_stack) vm->min_stack = addr; }
    else if (addr > vm->max_heap) vm->max_heap = addr;
}

/* keccak-f[1600] (for the custom instruction) */
static const uint64_t KC_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
static const int KC_ROT[5][5] = {
    {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}};

static inline uint64_t rol64(uint64_t x, int n)
{
    n &= 63; return n ? (x << n) | (x >> (64 - n)) : x;
}

static void keccak_f1600(uint64_t a[25])
{
    for (int r = 0; r < 24; r++) {
        uint64_t c[5], d[5], b[25];
        for (int x = 0; x < 5; x++)
            c[x] = a[x] ^ a[x+5] ^ a[x+10] ^ a[x+15] ^ a[x+20];
        for (int x = 0; x < 5; x++)
            d[x] = c[(x+4)%5] ^ rol64(c[(x+1)%5], 1);
        for (int i = 0; i < 25; i++) a[i] ^= d[i%5];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++)
                b[y + 5*((2*x + 3*y) % 5)] = rol64(a[x + 5*y],
                                                   KC_ROT[x][y]);
        for (int i = 0; i < 25; i++) {
            int xx = i % 5, yy = i / 5;
            a[i] = b[i] ^ ((~b[(xx+1)%5 + 5*yy]) & b[(xx+2)%5 + 5*yy]);
        }
        a[0] ^= KC_RC[r];
    }
}

/* run the trace pass.  record=0 -> discovery only (no SoA writes). */
long nexus_vm_run(
    uint8_t *mem, uint8_t *mode, uint32_t mem_end,
    uint32_t prog_start, uint32_t prog_end,
    const uint8_t *p_opc, const uint8_t *p_type, const uint8_t *p_rd,
    const uint8_t *p_rs1, const uint8_t *p_rs2, const uint32_t *p_imm,
    const uint32_t *p_word,
    uint32_t exit_addr, uint32_t heap_start, uint32_t stack_top,
    uint32_t entry,
    const uint8_t *priv, uint32_t priv_len,
    uint8_t *log_buf, uint32_t log_cap,
    uint32_t *log_splits, uint32_t log_splits_cap,
    uint32_t *ram_ts,
    uint32_t *regs_out, uint64_t *reg_ts_out,
    uint32_t *stats_out,    /* [max_heap, min_stack, n_logs, n_keccak] */
    int record,
    /* keccak state log: one row per keccakf instruction */
    uint32_t *kk_clk, uint32_t *kk_addr, uint32_t *kk_in,
    uint32_t *kk_out, uint32_t *kk_pts, long kk_cap,
    /* SoA outputs */
    uint32_t *o_clk, uint32_t *o_pc, uint32_t *o_next_pc,
    uint32_t *o_word, uint8_t *o_opcode, uint8_t *o_rd, uint8_t *o_rs1,
    uint8_t *o_rs2, uint32_t *o_imm, uint32_t *o_a_val,
    uint32_t *o_b_val, uint32_t *o_c_val, uint32_t *o_a_prev,
    uint32_t *o_ts1, uint32_t *o_ts2, uint32_t *o_ts3,
    uint8_t *o_rdw, uint32_t *o_maddr, uint8_t *o_msize,
    uint8_t *o_mstore, uint32_t *o_mval, uint32_t *o_mprev,
    uint32_t *o_mnew, uint32_t *o_mpts,
    long cap, long max_steps, int *exit_code_out)
{
    vm_t V;
    vm_t *vm = &V;
    memset(vm, 0, sizeof(*vm));
    vm->mem = mem; vm->mode = mode; vm->mem_end = mem_end;
    vm->prog_start = prog_start; vm->prog_end = prog_end;
    vm->exit_addr = exit_addr; vm->heap_start = heap_start;
    vm->stack_top = stack_top;
    vm->priv = priv; vm->priv_len = priv_len;
    vm->log_buf = log_buf; vm->log_cap = log_cap;
    vm->log_splits = log_splits; vm->log_splits_cap = log_splits_cap;
    vm->ram_ts = ram_ts;
    vm->min_stack = 0xFFFFFFFFu;
    vm->regs[2] = stack_top;

    uint32_t pc = entry;
    uint64_t clk = 1;
    long n = 0;
    long nkk = 0;
    *exit_code_out = -1;

    for (;;) {
        if (max_steps >= 0 && n >= max_steps) break;
        if (record && n >= cap) return -1;
        if (pc < prog_start || pc + 4 > prog_end || (pc & 3))
            return -2;
        uint32_t idx = (pc - prog_start) >> 2;
        uint8_t opc = p_opc[idx], t = p_type[idx];
        uint8_t rd = p_rd[idx], rs1 = p_rs1[idx], rs2 = p_rs2[idx];
        uint32_t imm = p_imm[idx];

        uint32_t b_val = vm->regs[rs1];
        uint32_t next_pc = pc + 4;
        uint32_t a_val = 0, c_val = 0;
        int wrote = 0, exited = 0, exit_code = 0;
        uint32_t m_addr = 0, m_val = 0, m_prev = 0, m_new = 0, m_pts = 0;
        uint8_t m_size = 0, m_store = 0;

        switch (t) {
        case T_R: {
            c_val = vm->regs[rs2];
            uint32_t a = b_val, b = c_val;
            switch (opc) {
            case OP_ADD: a_val = a + b; break;
            case OP_SUB: a_val = a - b; break;
            case OP_SLL: a_val = a << (b & 31); break;
            case OP_SLT: a_val = s32(a) < s32(b); break;
            case OP_SLTU: a_val = a < b; break;
            case OP_XOR: a_val = a ^ b; break;
            case OP_SRL: a_val = a >> (b & 31); break;
            case OP_SRA: a_val = (uint32_t)(s32(a) >> (b & 31)); break;
            case OP_OR: a_val = a | b; break;
            case OP_AND: a_val = a & b; break;
            case OP_MUL: a_val = a * b; break;
            case OP_MULH:
                a_val = (uint32_t)(((int64_t)s32(a) * s32(b)) >> 32);
                break;
            case OP_MULHSU:
                a_val = (uint32_t)(((int64_t)s32(a) * (uint64_t)b) >> 32);
                break;
            case OP_MULHU:
                a_val = (uint32_t)(((uint64_t)a * b) >> 32);
                break;
            case OP_DIV:
                if (b == 0) a_val = 0xFFFFFFFFu;
                else if (a == 0x80000000u && b == 0xFFFFFFFFu)
                    a_val = 0x80000000u;
                else a_val = (uint32_t)(s32(a) / s32(b));
                break;
            case OP_DIVU: a_val = b ? a / b : 0xFFFFFFFFu; break;
            case OP_REM:
                if (b == 0) a_val = a;
                else if (a == 0x80000000u && b == 0xFFFFFFFFu) a_val = 0;
                else a_val = (uint32_t)(s32(a) % s32(b));
                break;
            case OP_REMU: a_val = b ? a % b : a; break;
            default: return -2;
            }
            wrote = 1;
            break;
        }
        case T_I: {
            c_val = imm;
            switch (opc) {
            case OP_ADDI: a_val = b_val + imm; wrote = 1; break;
            case OP_SLLI: a_val = b_val << (imm & 31); wrote = 1; break;
            case OP_SLTI: a_val = s32(b_val) < s32(imm); wrote = 1; break;
            case OP_SLTIU: a_val = b_val < imm; wrote = 1; break;
            case OP_XORI: a_val = b_val ^ imm; wrote = 1; break;
            case OP_SRLI: a_val = b_val >> (imm & 31); wrote = 1; break;
            case OP_SRAI:
                a_val = (uint32_t)(s32(b_val) >> (imm & 31));
                wrote = 1; break;
            case OP_ORI: a_val = b_val | imm; wrote = 1; break;
            case OP_ANDI: a_val = b_val & imm; wrote = 1; break;
            case OP_JALR:
                a_val = next_pc;
                next_pc = (b_val + imm) & ~1u;
                wrote = 1; break;
            case OP_FENCE: c_val = 0; break;
            case OP_LB: case OP_LH: case OP_LW: case OP_LBU:
            case OP_LHU: {
                uint32_t addr = b_val + imm;
                uint32_t size = (opc == OP_LW) ? 4 :
                                (opc == OP_LH || opc == OP_LHU) ? 2 : 1;
                if (!mem_check(vm, addr, size, 0)) return -2;
                uint32_t raw = mem_load(vm, addr, size);
                track(vm, addr);
                uint32_t w = addr & ~3u;
                m_pts = vm->ram_ts[w >> 2];
                m_prev = mem_load(vm, w, 4);
                vm->ram_ts[w >> 2] = (uint32_t)clk;
                if (opc == OP_LB) a_val = (uint32_t)(int32_t)(int8_t)raw;
                else if (opc == OP_LH)
                    a_val = (uint32_t)(int32_t)(int16_t)raw;
                else a_val = raw;
                wrote = 1;
                m_addr = addr; m_size = size; m_store = 0;
                m_val = raw; m_new = m_prev;
                break;
            }
            default: return -2;
            }
            break;
        }
        case T_S: {
            c_val = vm->regs[rs2];
            uint32_t addr = b_val + imm;
            uint32_t size = (opc == OP_SW) ? 4 : (opc == OP_SH) ? 2 : 1;
            if (!mem_check(vm, addr, size, 1)) return -2;
            uint32_t w = addr & ~3u;
            m_pts = vm->ram_ts[w >> 2];
            m_prev = mem_load(vm, w, 4);
            vm->ram_ts[w >> 2] = (uint32_t)clk;
            uint32_t value = c_val & (size == 4 ? 0xFFFFFFFFu
                                     : size == 2 ? 0xFFFFu : 0xFFu);
            memcpy(vm->mem + addr, &value, size);
            track(vm, addr);
            uint32_t ofs = addr & 3;
            uint32_t lane = (size == 4 ? 0xFFFFFFFFu
                             : size == 2 ? 0xFFFFu : 0xFFu) << (8 * ofs);
            m_new = (m_prev & ~lane) | ((value << (8 * ofs)) & lane);
            m_addr = addr; m_size = size; m_store = 1; m_val = value;
            break;
        }
        case T_B: {
            c_val = vm->regs[rs2];
            int take = 0;
            switch (opc) {
            case OP_BEQ: take = b_val == c_val; break;
            case OP_BNE: take = b_val != c_val; break;
            case OP_BLT: take = s32(b_val) < s32(c_val); break;
            case OP_BGE: take = s32(b_val) >= s32(c_val); break;
            case OP_BLTU: take = b_val < c_val; break;
            case OP_BGEU: take = b_val >= c_val; break;
            }
            if (take) next_pc = pc + imm;
            break;
        }
        case T_J:
            c_val = imm;
            a_val = next_pc;
            next_pc = pc + imm;
            wrote = 1;
            break;
        case T_U:
            c_val = imm;
            a_val = (opc == OP_LUI) ? imm : pc + imm;
            wrote = 1;
            break;
        case T_SYS: {
            c_val = vm->regs[rs2];
            if (opc == OP_EBREAK) break;
            uint32_t code = vm->regs[17];
            uint32_t a0 = vm->regs[10], a1 = vm->regs[11],
                     a2 = vm->regs[12];
            rd = 10;
            switch (code) {
            case 0x200: {                   /* Write */
                if (a0 == 1) {
                    uint32_t len = a2;      /* short read past end, like
                                               the Python unchecked read */
                    if (a1 >= vm->mem_end) len = 0;
                    else if (a1 + len > vm->mem_end)
                        len = vm->mem_end - a1;
                    if (vm->log_len + len <= vm->log_cap &&
                        vm->n_logs < vm->log_splits_cap) {
                        memcpy(vm->log_buf + vm->log_len,
                               vm->mem + a1, len);
                        vm->log_len += len;
                        vm->log_splits[vm->n_logs++] = vm->log_len;
                    }
                    a_val = a2;
                } else a_val = 0xFFFFFFFFu;
                wrote = 1;
                break;
            }
            case 0x201: {                   /* Exit */
                exited = 1;
                exit_code = (int)a0;
                next_pc = pc;
                rd = 0;
                uint32_t w = vm->exit_addr;
                if (!mem_check(vm, w, 4, 1)) return -2;
                m_pts = vm->ram_ts[w >> 2];
                m_prev = mem_load(vm, w, 4);
                vm->ram_ts[w >> 2] = (uint32_t)clk;
                memcpy(vm->mem + w, &a0, 4);
                m_new = a0;
                m_addr = w; m_size = 4; m_store = 1; m_val = a0;
                break;
            }
            case 0x400:                     /* ReadFromPrivateInput */
                a_val = (vm->priv_pos < vm->priv_len)
                    ? vm->priv[vm->priv_pos++] : 0xFFFFFFFFu;
                wrote = 1;
                break;
            case 0x401: {                   /* CycleCount: nop */
                break;
            }
            case 0x402:                     /* OverwriteStackPointer */
                a_val = vm->stack_top; wrote = 1; rd = 2; break;
            case 0x403:                     /* OverwriteHeapPointer */
                a_val = vm->heap_start; wrote = 1; break;
            case 0x405: break;              /* MemoryAdvise: nop */
            default: return -2;
            }
            break;
        }
        case T_CUSTOM: {
            c_val = vm->regs[rs2];
            if (opc != OP_KECCAKF) return -2;
            uint64_t st[25];
            int logit = (kk_clk != 0 && nkk < kk_cap);
            for (int i = 0; i < 25; i++) {
                if (!mem_check(vm, b_val + 8 * i, 4, 0) ||
                    !mem_check(vm, b_val + 8 * i + 4, 4, 0)) return -2;
                st[i] = (uint64_t)mem_load(vm, b_val + 8 * i, 4)
                    | ((uint64_t)mem_load(vm, b_val + 8 * i + 4, 4) << 32);
            }
            /* one recorded access pair per word (matches the Python
               mem_prev bookkeeping: capture prev ts, stamp clk) */
            for (int i = 0; i < 50; i++) {
                uint32_t w = (b_val + 4 * i) >> 2;
                if (logit) {
                    kk_pts[50 * nkk + i] = vm->ram_ts[w];
                    kk_in[50 * nkk + i] =
                        (uint32_t)(st[i / 2] >> (32 * (i & 1)));
                }
                vm->ram_ts[w] = (uint32_t)clk;
            }
            keccak_f1600(st);
            for (int i = 0; i < 25; i++) {
                if (!mem_check(vm, b_val + 8 * i, 4, 1) ||
                    !mem_check(vm, b_val + 8 * i + 4, 4, 1)) return -2;
                memcpy(vm->mem + b_val + 8 * i, &st[i], 8);
            }
            if (logit) {
                kk_clk[nkk] = (uint32_t)clk;
                kk_addr[nkk] = b_val;
                for (int i = 0; i < 50; i++)
                    kk_out[50 * nkk + i] =
                        (uint32_t)(st[i / 2] >> (32 * (i & 1)));
            }
            nkk++;
            break;
        }
        default:
            return -2;
        }

        /* register slot bookkeeping (matches emulator.py exactly) */
        int uses_rs2 = (t == T_R || t == T_S || t == T_B ||
                        t == T_CUSTOM || opc == OP_ECALL);
        uint32_t ts1_prev = (uint32_t)vm->reg_ts[rs1];
        vm->reg_ts[rs1] = 3 * clk + 1;
        uint32_t ts2_prev = 0;
        if (uses_rs2) {
            ts2_prev = (uint32_t)vm->reg_ts[rs2];
            vm->reg_ts[rs2] = 3 * clk + 2;
        }
        uint32_t a_prev = 0, ts3_prev = 0;
        if (wrote) {
            a_prev = vm->regs[rd];
            ts3_prev = (uint32_t)vm->reg_ts[rd];
            vm->reg_ts[rd] = 3 * clk + 3;
            if (rd != 0) vm->regs[rd] = a_val;
        }

        if (record) {
            o_clk[n] = (uint32_t)clk; o_pc[n] = pc;
            o_next_pc[n] = next_pc; o_word[n] = p_word[idx];
            o_opcode[n] = opc; o_rd[n] = rd; o_rs1[n] = rs1;
            o_rs2[n] = rs2; o_imm[n] = imm;
            o_a_val[n] = wrote ? a_val : 0;
            o_b_val[n] = b_val; o_c_val[n] = c_val;
            o_a_prev[n] = a_prev;
            o_ts1[n] = ts1_prev; o_ts2[n] = ts2_prev;
            o_ts3[n] = ts3_prev; o_rdw[n] = wrote;
            o_maddr[n] = m_addr; o_msize[n] = m_size;
            o_mstore[n] = m_store; o_mval[n] = m_val;
            o_mprev[n] = m_prev; o_mnew[n] = m_new; o_mpts[n] = m_pts;
        }
        n++;
        clk++;
        pc = next_pc;
        if (exited) {
            *exit_code_out = exit_code;
            for (int i = 0; i < 32; i++) {
                regs_out[i] = vm->regs[i];
                reg_ts_out[i] = vm->reg_ts[i];
            }
            stats_out[0] = vm->max_heap;
            stats_out[1] = vm->min_stack;
            stats_out[2] = vm->n_logs;
            stats_out[3] = (uint32_t)nkk;
            return n;
        }
    }
    return -3;
}
